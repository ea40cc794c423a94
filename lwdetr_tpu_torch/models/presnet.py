"""PResNet (ResNet-vd), the alternative encoder (`--encoder res18vd | res50vd`).

Counterpart of `lwdetr_tpu/models/presnet.py`: the deep stem (three 3x3
convolutions), four stages of basic blocks (depth 18, 34) or bottlenecks
(50, 101), variant "d" (a stride-2 shortcut average-pools before its 1x1
convolution), and the stages of `return_idx` (1, 2, 3) brought to one
stride-16 grid and concatenated: stage 1 max-pooled, stage 3 repeated 2x
nearest. One map (B, H / 16, W / 16, `out_channels[0]`), channel-last at the
module boundary as in the JAX package; the convolutions run on NCHW inside
(cuDNN on the card: the JAX package leaves them to XLA, outside any Pallas
kernel).

Every BatchNorm is frozen (`freeze_norm=True`, the JAX default): it
normalizes with its running statistics in train mode too, and never updates
them; its weight and bias still train. It computes as flax's
`nn.BatchNorm(use_running_average=True)`: (x - mean) x (rsqrt(var + eps) x
scale) + bias in float32, rounded once to the input's dtype.

Module names follow the flax tree (`conv1_1`, `res{stage}_{block}.branch2a.
conv`, `...short_conv.norm`), so the state_dict keys under
`backbone.0.encoder.` are those names with torch's `weight`, `bias`,
`running_mean`, `running_var`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lwdetr_tpu_torch.models.cast import Conv2d

# blocks a stage, by depth (`lwdetr_tpu/models/presnet.py:22-27`)
RESNET_CFG = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}
STAGE_CHANNELS = (64, 128, 256, 512)


def depth_of(encoder: str) -> int:
    """The depth an `--encoder` name gives PResNet: its digits (`res50vd` -> 50)."""
    return int("".join(c for c in encoder if c.isdigit()))


def out_channels(depth: int, return_idx: Tuple[int, ...] = (1, 2, 3)):
    """[channels of the one concatenated map] of PResNet at `depth`: 896 for
    18 and 34, 3584 for 50 and 101."""
    expansion = 4 if depth >= 50 else 1
    return [sum(expansion * STAGE_CHANNELS[i] for i in return_idx)]


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm on its running statistics in every mode (flax's
    `use_running_average=True`), which it never updates; the affine weight
    and bias take gradients. f32 arithmetic, the result in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class ConvNorm(nn.Module):
    """Conv (no bias, 'same' padding) -> frozen BatchNorm -> optional ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, act: bool = False):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride, padding=(kernel - 1) // 2, bias=False)
        self.norm = FrozenBatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        return F.relu(x) if self.act else x


def avg_pool_2x_ceil(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_avg_pool_2x_ceil` (`lwdetr_tpu/models/presnet.py:
    58-67`): an odd side is first padded by repeating its last row / column
    (edge padding), then 2x2 mean pooling with stride 2. This equals the
    reference's `AvgPool2d(ceil_mode=True)` here: a border cell holds each
    valid element twice, so its mean is the mean of the valid elements."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    return F.avg_pool2d(x, 2, 2)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2, 1)


def _shortcut(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if block.shortcut:
        return x
    if hasattr(block, "short_conv"):
        return block.short_conv(avg_pool_2x_ceil(x))
    return block.short(x)


def _add_shortcut_layers(block: nn.Module, cin: int, cout: int, stride: int, shortcut: bool,
                         variant: str) -> None:
    block.shortcut = shortcut
    if shortcut:
        return
    if variant == "d" and stride == 2:
        block.short_conv = ConvNorm(cin, cout, 1, 1)
    else:
        block.short = ConvNorm(cin, cout, 1, stride)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, ch_out: int, stride: int, shortcut: bool, variant: str = "d"):
        super().__init__()
        self.branch2a = ConvNorm(cin, ch_out, 3, stride, act=True)
        self.branch2b = ConvNorm(ch_out, ch_out, 3, 1)
        _add_shortcut_layers(self, cin, ch_out, stride, shortcut, variant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.branch2b(self.branch2a(x)) + _shortcut(self, x))


class BottleNeck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, ch_out: int, stride: int, shortcut: bool, variant: str = "d"):
        super().__init__()
        s1, s2 = (stride, 1) if variant == "a" else (1, stride)
        self.branch2a = ConvNorm(cin, ch_out, 1, s1, act=True)
        self.branch2b = ConvNorm(ch_out, ch_out, 3, s2, act=True)
        self.branch2c = ConvNorm(ch_out, ch_out * 4, 1, 1)
        _add_shortcut_layers(self, cin, ch_out * 4, stride, shortcut, variant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.branch2c(self.branch2b(self.branch2a(x)))
        return F.relu(out + _shortcut(self, x))


class PResNet(nn.Module):
    """(B, H, W, 3) images -> [(B, H / 16, W / 16, out_channels[0])]."""

    def __init__(self, depth: int = 50, variant: str = "d",
                 return_idx: Tuple[int, ...] = (1, 2, 3)):
        super().__init__()
        if depth not in RESNET_CFG:
            raise ValueError(f"PResNet depth must be one of {sorted(RESNET_CFG)}, got {depth}")
        if any(i < 1 or i > 3 for i in return_idx):
            raise ValueError(f"return_idx must lie in 1..3 (one stride-16 grid), got {return_idx}")
        self.depth, self.return_idx = depth, tuple(return_idx)
        block_cls = BottleNeck if depth >= 50 else BasicBlock
        self.conv1_1 = ConvNorm(3, 32, 3, 2, act=True)
        self.conv1_2 = ConvNorm(32, 32, 3, 1, act=True)
        self.conv1_3 = ConvNorm(32, 64, 3, 1, act=True)
        cin = 64
        self.blocks = []  # (stage, block name) in order
        for i, n in enumerate(RESNET_CFG[depth]):
            for b in range(n):
                stride = 2 if (b == 0 and i != 0) else 1
                name = f"res{i}_{b}"
                self.add_module(name, block_cls(cin, STAGE_CHANNELS[i], stride, b != 0, variant))
                self.blocks.append((i, name))
                cin = STAGE_CHANNELS[i] * block_cls.expansion

    @property
    def out_channels(self):
        return out_channels(self.depth, self.return_idx)

    def forward(self, images: torch.Tensor, drop_path_rates=None, mask_source=None):
        x = images.permute(0, 3, 1, 2)
        x = max_pool_3x3_s2(self.conv1_3(self.conv1_2(self.conv1_1(x))))
        outs = []
        for k, (stage, name) in enumerate(self.blocks):
            x = getattr(self, name)(x)
            last_of_stage = k + 1 == len(self.blocks) or self.blocks[k + 1][0] != stage
            if last_of_stage and stage in self.return_idx:
                if stage == 1:
                    outs.append(max_pool_3x3_s2(x))
                elif stage == 3:  # nearest 2x (reference presnet.py:345-347)
                    outs.append(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))
                else:
                    outs.append(x)
        return [torch.cat(outs, dim=1).permute(0, 2, 3, 1)]
