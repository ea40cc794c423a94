"""Multi-scale projector: per-scale resampling + C2f (CSP bottleneck) fusion.

Counterpart of `lwdetr_tpu/models/projector.py`. For each output
scale every ViT tap is resampled (transposed convolutions up for P3 / 4x,
a stride-2 convolution down for P5, nothing for P4), the taps are
concatenated along channels, fused by a YOLOv8-style C2f block and
normalized by a channel LayerNorm; P6 is a stride-2 subsample of the last
map. Maps stay channel-last (B, H, W, C) at the module boundary, as in the
JAX package; the convolutions run on NCHW inside (`F.conv2d`, as the JAX
package leaves them to XLA). Module names follow the reference's state_dict
(`stages_sampling.{scale}.{tap}.{i}`, `stages.{scale}.0|1`).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lwdetr_tpu_torch.models.cast import Conv2d, ConvTranspose2d

LEVEL2SCALE = {"P3": 2.0, "P4": 1.0, "P5": 0.5, "P6": 0.25}


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train mode keeps the JAX package's running
    statistics: it normalizes with the batch mean and the biased batch
    variance, as stock PyTorch does, but also stores the *biased* variance in
    `running_var` (flax's `nn.BatchNorm`), where stock PyTorch stores the
    unbiased one (x N / (N - 1)). momentum 0.1 here is flax's 0.9."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            xf = x.detach().float()
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvX(nn.Module):
    """Conv(bias=False) + BatchNorm + activation, NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 act: str = "relu"):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)
        self.bn = BatchNorm2d(cout, eps=1e-5, momentum=0.1)
        self.act = {"silu": F.silu, "relu": F.relu}[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    """Two 3x3 ConvX with an optional residual."""

    def __init__(self, c: int, shortcut: bool = False, act: str = "silu"):
        super().__init__()
        self.cv1 = ConvX(c, c, 3, act=act)
        self.cv2 = ConvX(c, c, 3, act=act)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convolutions (hidden channels = out / 2), NCHW."""

    def __init__(self, cin: int, cout: int, num_blocks: int = 3, act: str = "silu"):
        super().__init__()
        self.c = cout // 2
        self.cv1 = ConvX(cin, 2 * self.c, 1, act=act)
        self.cv2 = ConvX((2 + num_blocks) * self.c, cout, 1, act=act)
        self.m = nn.ModuleList(Bottleneck(self.c, act=act) for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = list(self.cv1(x).split(self.c, dim=1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of NCHW maps (eps 1e-6), in f32."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        u = xf.mean(dim=1, keepdim=True)
        s = (xf - u).square().mean(dim=1, keepdim=True)
        xf = (xf - u) / torch.sqrt(s + self.eps)
        out = self.weight.float()[:, None, None] * xf + self.bias.float()[:, None, None]
        return out.to(x.dtype)


class GELU(nn.Module):
    """erf GELU in f32 (the parity dtype), tanh GELU in bf16, as in the JAX package."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def sampling_layers(scale: float, in_dim: int):
    """(layers resampling one (B, in_dim, H, W) tap to `scale`, their output channels)."""
    if scale == 4.0:  # ConvT(2, 2) -> channel LN -> GELU -> ConvT(2, 2); C -> C / 4
        return [ConvTranspose2d(in_dim, in_dim // 2, 2, stride=2),
                ChannelLayerNorm(in_dim // 2), GELU(),
                ConvTranspose2d(in_dim // 2, in_dim // 4, 2, stride=2)], in_dim // 4
    if scale == 2.0:  # [1x1 reduce if C > 512] -> ConvT(2, 2)
        if in_dim > 512:
            return [ConvX(in_dim, in_dim // 2, 1),
                    ConvTranspose2d(in_dim // 2, in_dim // 4, 2, stride=2)], in_dim // 4
        return [ConvTranspose2d(in_dim, in_dim // 2, 2, stride=2)], in_dim // 2
    if scale == 1.0:
        return [], in_dim
    if scale == 0.5:  # stride-2 3x3 ConvX, channels preserved
        return [ConvX(in_dim, in_dim, 3, stride=2)], in_dim
    raise NotImplementedError(f"unsupported scale {scale}")


class MultiScaleProjector(nn.Module):
    """list of (B, H, W, C_in) taps -> list of (B, H * s, W * s, out_channels)
    maps, one per scale factor s; a scale of 0.25 (last) adds a stride-2
    subsample of the map before it."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 scale_factors: Sequence[float], num_blocks: int = 3):
        super().__init__()
        self.extra_pool = 0.25 in scale_factors
        self.stages_sampling = nn.ModuleList()
        self.stages = nn.ModuleList()
        for scale in scale_factors:
            if scale == 0.25:
                continue
            taps = [sampling_layers(scale, in_dim) for in_dim in in_channels]
            self.stages_sampling.append(
                nn.ModuleList(nn.Sequential(*layers) for layers, _ in taps))
            self.stages.append(nn.Sequential(
                C2f(sum(c for _, c in taps), out_channels, num_blocks),
                ChannelLayerNorm(out_channels)))

    def forward(self, feats):
        feats = [f.permute(0, 3, 1, 2) for f in feats]
        results = []
        for sampling, stage in zip(self.stages_sampling, self.stages):
            x = torch.cat([m(f) for m, f in zip(sampling, feats)], dim=1)
            results.append(stage(x).permute(0, 2, 3, 1))
        if self.extra_pool:
            results.append(results[-1][:, ::2, ::2, :])
        return results
