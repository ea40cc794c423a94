"""ViTDet-style plain ViT encoder with interleaved window/global attention.

Counterpart of `lwdetr_tpu/models/vit.py`, eval and train:

* channel-last (B, H, W, C) maps; the token buffer is reorganized once into
  16 windows (B*16, hw, C); window blocks attend within a window and global
  blocks view the same buffer as (B, 16*hw, C);
* the pretraining position embedding is resized with the exact
  torch-bicubic matrices (ops/resize.py);
* CAE mode: fused qkv with bias concat(q_bias, 0, v_bias); the softmax scale
  is folded into the q projection and the layer scales gamma_1 / gamma_2
  into proj / fc2, in float32 at forward time (built once in eval,
  `models/cast.py`), so the parameters keep the reference's values and names;
  each weight is cast to the activations' dtype where it is used;
* attention runs channel-major: the qkv product writes (B, 3C, N), the
  attention (ops/flash_attention.attention_cm: K1 for windows, K2 for global
  blocks; K7 and K6 in the backward) returns (B, C, N), and the projection
  reads it back;
* stochastic depth in train mode: each block takes its rate (the linear ramp
  of `train/optim.drop_path_rates_for`) and drops rows of the window-major
  buffer after the gamma-scaled attention and after the gamma-scaled MLP,
  one mask a window row (B * 16, 1, 1), as the JAX mask has that shape on the
  same buffer (`models/drop.py`);
* remat (`grad_checkpointing`): each block runs under
  `torch.utils.checkpoint`, so that its activations are recomputed in the
  backward (the JAX package's `nn.remat(Block)`); its two masks are drawn
  before, outside the checkpointed function, so that the recompute applies
  the same masks (`preserve_rng_state` restores the default generators, not an
  explicit one). The forward kernels then run twice a block and step.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lwdetr_tpu_torch.models import drop
from lwdetr_tpu_torch.models.cast import LayerNorm, Linear, cast_params, weight_and_bias
from lwdetr_tpu_torch.ops import flash_attention as fa
from lwdetr_tpu_torch.ops.resize import bicubic_resize_2d

NUM_WINDOWS_SIDE = 4  # fixed 4x4 = 16 windows


def get_abs_pos(pos_embed: torch.Tensor, has_cls_token: bool, hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (1, num_pos, C) pretraining pos-embed to (1, H, W, C)."""
    if has_cls_token:
        pos_embed = pos_embed[:, 1:]
    xy_num = pos_embed.shape[1]
    size = int(math.sqrt(xy_num))
    if size * size != xy_num:
        raise ValueError("pos_embed grid must be square")
    return bicubic_resize_2d(pos_embed.reshape(1, size, size, -1), hw)


def dense_cm(x_t: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Linear layer reading channel-major (B, C_in, N), writing (B, N, C_out)."""
    return torch.matmul(x_t.transpose(1, 2), weight.t()) + bias


def dense_to_cm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Linear layer reading (B, N, C_in), writing channel-major (B, C_out, N)."""
    return torch.matmul(weight, x.transpose(1, 2)) + bias[:, None]


def folded(layer: nn.Linear, out_scale: Optional[torch.Tensor], dtype: torch.dtype):
    """(weight, bias) of `layer` in `dtype`, with an optional (out,) scale
    folded into both in float32 before the one cast."""
    if out_scale is None:
        return weight_and_bias(layer, dtype)
    return cast_params(layer, "folded", dtype, (layer.weight, layer.bias, out_scale),
                       lambda: (layer.weight * out_scale[:, None], layer.bias * out_scale))


class DenseCM(nn.Linear):
    """`nn.Linear` (same parameters) applied to channel-major input, with an
    optional (out,) scale folded into weight and bias."""

    def forward(self, x_t: torch.Tensor, out_scale: Optional[torch.Tensor] = None):
        return dense_cm(x_t, *folded(self, out_scale, x_t.dtype))


class Attention(nn.Module):
    """Fused-qkv multi-head self-attention with the CAE bias (q_bias, 0, v_bias)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = DenseCM(dim, dim)

    def qkv_weight_bias(self, dtype: torch.dtype):
        """The fused projection with the softmax scale folded into its q rows,
        in float32: the (3C, C) weight cast once to `dtype`, the (3C,) bias
        concat(q_bias, 0, v_bias) left in float32 (the attention adds it in
        the activations' dtype), as `lwdetr_tpu/models/vit.py:99-110`."""
        w, qb, vb = self.qkv.weight, self.q_bias, self.v_bias
        C = qb.shape[0]
        (w,) = cast_params(self, "qkv", dtype, (w,),
                           lambda: (torch.cat([w[:C] * self.scale, w[C:]]),))
        (bias,) = cast_params(self, "qkv_bias", qb.dtype, (qb, vb), lambda: (
            torch.cat([qb * self.scale, torch.zeros_like(qb), vb]),))
        return w, bias

    def forward(self, x: torch.Tensor, out_scale: Optional[torch.Tensor] = None):
        w, bias = self.qkv_weight_bias(x.dtype)
        qkv_t = torch.matmul(w, x.transpose(1, 2))  # (B, 3C, N)
        out_t = fa.attention_cm(qkv_t, self.num_heads, scale=1.0, bias=bias)
        return self.proj(out_t, out_scale)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, out_scale: Optional[torch.Tensor] = None):
        x = self.fc1(x)
        # exact erf GELU in f32 (the parity dtype); tanh in bf16, where it is
        # within one bf16 ulp of erf, as in the JAX package
        x = F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")
        return F.linear(x, *folded(self.fc2, out_scale, x.dtype))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: bool, mlp_ratio: float = 4.0):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma_1 = nn.Parameter(torch.full((dim,), 0.1))
        self.gamma_2 = nn.Parameter(torch.full((dim,), 0.1))

    def forward(self, x: torch.Tensor, drop_attn=None, drop_mlp=None) -> torch.Tensor:
        """x: (B*16, hw, C) window-major token buffer; drop_attn / drop_mlp:
        the `drop.draw` results of the block's two stochastic-depth sites, or
        None."""
        Bw, HW, C = x.shape
        h = self.norm1(x)
        if not self.window:
            h = h.reshape(Bw // 16, 16 * HW, C)
        h = self.attn(h, out_scale=self.gamma_1)
        x = x + drop.apply(h.reshape(Bw, HW, C), drop_attn)
        return x + drop.apply(self.mlp(self.norm2(x), out_scale=self.gamma_2), drop_mlp)


class PatchEmbedGEMM(nn.Module):
    """stride == kernel patch-embed conv as a patch regroup + GEMM. The
    parameter is the reference's conv weight (C, Cin, P, P) at `proj`."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H_img, W_img, Cin) -> (B, H, W, C)."""
        B, Hi, Wi, Cin = x.shape
        P = self.patch_size
        x5 = x.reshape(B, Hi // P, P, Wi // P, P * Cin)
        w = self.proj.weight
        k, b = cast_params(self, "kernel", x.dtype, (w, self.proj.bias),
                           lambda: (w.permute(2, 3, 1, 0).reshape(P, P * Cin, -1), self.proj.bias))
        return torch.einsum("bhpwq,pqc->bhwc", x5, k) + b


class ViT(nn.Module):
    """Plain ViT with multi-level feature taps; returns (B, H, W, C) maps at
    `out_feature_indexes`."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int = 12,
                 patch_size: int = 16, mlp_ratio: float = 4.0,
                 window_block_indexes: Sequence[int] = (),
                 out_feature_indexes: Sequence[int] = (-1,),
                 pretrain_img_size: int = 224, pretrain_use_cls_token: bool = True,
                 grad_checkpointing: bool = False):
        super().__init__()
        self.grad_checkpointing = grad_checkpointing
        num_positions = (pretrain_img_size // patch_size) ** 2 + int(pretrain_use_cls_token)
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.pos_embed = nn.Parameter(torch.zeros(1, num_positions, embed_dim))
        self.patch_embed = PatchEmbedGEMM(3, embed_dim, patch_size)
        out_idx = {i if i >= 0 else i + depth for i in out_feature_indexes}
        self.out_flags = tuple(i in out_idx for i in range(depth))
        if not self.out_flags[-1]:
            raise ValueError("last block must be an output feature")
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, window=i in window_block_indexes, mlp_ratio=mlp_ratio)
            for i in range(depth))

    def forward(self, x: torch.Tensor, drop_path_rates: Optional[Sequence[float]] = None,
                mask_source: Optional[drop.MaskSource] = None):
        """x (B, H_img, W_img, 3) -> list[(B, H, W, C)], H = H_img // patch.
        drop_path_rates: one rate a block (None: no stochastic depth), whose
        masks `mask_source` draws (None: none drawn, as in eval)."""
        x = self.patch_embed(x)
        B, H, W, C = x.shape
        # resized in float32, cast once
        (pos,) = cast_params(self, ("pos_embed", H, W), x.dtype, (self.pos_embed,), lambda: (
            get_abs_pos(self.pos_embed, self.pretrain_use_cls_token, (H, W)),))
        x = x + pos
        if H % NUM_WINDOWS_SIDE or W % NUM_WINDOWS_SIDE:
            raise ValueError(f"token grid {H}x{W} must divide into 4x4 windows")
        h, w = H // NUM_WINDOWS_SIDE, W // NUM_WINDOWS_SIDE
        x = x.reshape(B, NUM_WINDOWS_SIDE, h, NUM_WINDOWS_SIDE, w, C)
        x = x.transpose(2, 3).reshape(B * 16, h * w, C)
        outs = []
        rates = [0.0] * len(self.blocks) if drop_path_rates is None else list(drop_path_rates)
        if len(rates) != len(self.blocks):
            raise ValueError(f"{len(rates)} drop-path rates for {len(self.blocks)} blocks")
        remat = self.grad_checkpointing and torch.is_grad_enabled()
        for blk, tap, rate in zip(self.blocks, self.out_flags, rates):
            # both masks drawn here, in the JAX order, before any recompute
            drop_attn = drop.drop_path_mask(mask_source, rate, x)
            drop_mlp = drop.drop_path_mask(mask_source, rate, x)
            if remat:
                x = checkpoint(blk, x, drop_attn, drop_mlp, use_reentrant=False)
            else:
                x = blk(x, drop_attn, drop_mlp)
            if tap:
                o = x.reshape(B, NUM_WINDOWS_SIDE, NUM_WINDOWS_SIDE, h, w, C)
                outs.append(o.transpose(2, 3).reshape(B, H, W, C))
        return outs
