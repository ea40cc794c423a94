"""Multi-scale projector: C2f (CSP bottleneck) fusion of the ViT taps.

Counterpart of `lwdetr_tpu/models/projector.py`, eval only, on the
scale-1.0 (P4) path: the taps are concatenated along channels, fused by a
YOLOv8-style C2f block and normalized by a channel LayerNorm. Maps stay
channel-last (B, H, W, C) at the module boundary, as in the JAX package; the
convolutions run on NCHW inside (`F.conv2d`, as the JAX package leaves them
to XLA). The up/down-sampling paths of P3/P5/P6 arrive with the large and
xlarge slice.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LEVEL2SCALE = {"P3": 2.0, "P4": 1.0, "P5": 0.5, "P6": 0.25}


class ConvX(nn.Module):
    """Conv(bias=False) + BatchNorm (eval) + activation, NCHW."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 act: str = "relu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
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


class MultiScaleProjector(nn.Module):
    """list of (B, H, W, C_in) taps -> list with one (B, H, W, out_channels) map."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 scale_factors: Sequence[float], num_blocks: int = 3):
        super().__init__()
        if list(scale_factors) != [1.0]:
            raise NotImplementedError(
                f"projector scales {list(scale_factors)}: only P4 (1.0) is ported so far")
        self.stages = nn.ModuleList([nn.Sequential(
            C2f(sum(in_channels), out_channels, num_blocks),
            ChannelLayerNorm(out_channels))])

    def forward(self, feats):
        x = torch.cat(feats, dim=-1).permute(0, 3, 1, 2)
        return [self.stages[0](x).permute(0, 2, 3, 1)]
