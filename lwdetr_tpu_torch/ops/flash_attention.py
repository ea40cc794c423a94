"""Exact softmax attention over channel-major packed qkv (B, 3C, N) -> (B, C, N).

Counterpart of `lwdetr_tpu/ops/flash_attention.py::attention_cm`, with the
same dispatch:

* a (3C,) qkv bias and N <= 128 (the ViT window blocks): K1,
  `csrc/window_attention.cu`, which adds the bias on the loaded panel;
* otherwise the bias, if any, is added inline and K2,
  `csrc/flash_attention.cu`, runs (the ViT global blocks and the decoder
  self-attention).

On a CUDA tensor the kernels run, or the call raises; a tensor on the CPU
takes the plain version, `attention_cm_plain`, which is also what the kernels
are held against on the card. Forward only: the backward kernels (K6, K7)
belong to the training slice.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from lwdetr_tpu_torch.ops._build import CudaKernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_WINDOW_MAX_N = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# K1 replaces lwdetr_tpu/ops/flash_attention.py:95 _attn_cm_allheads_bias_kernel
window_attention_bias_kernel = CudaKernel(
    "K1", "window_attention.cu", "lw_window_attention_bias",
    [_P, _P, _P, _I, _I, _I, _I, _F, _I])
# K2 replaces lwdetr_tpu/ops/flash_attention.py:43 _attn_cm_kernel
flash_attention_cm_kernel = CudaKernel(
    "K2", "flash_attention.cu", "lw_flash_attention_cm",
    [_P, _P, _I, _I, _I, _I, _F, _I])


def attention_cm_plain(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version (counterpart of `_xla_sdpa_cm`): f32 scores,
    exact softmax, result in the input's dtype."""
    B, ZC, N = qkv_t.shape
    C = ZC // 3
    D = C // num_heads
    x = qkv_t.float().reshape(B, 3, num_heads, D, N)
    q, k, v = x[:, 0], x[:, 1], x[:, 2]  # (B, H, D, N)
    s = torch.einsum("bhdn,bhdm->bhnm", q * scale, k)
    o = torch.einsum("bhnm,bhdm->bhdn", s.softmax(dim=-1), v)
    return o.reshape(B, C, N).to(qkv_t.dtype)


def _check_cuda(qkv_t: torch.Tensor, num_heads: int, *extra: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (qkv_t,) + extra):
        raise NotImplementedError(
            "attention_cm on CUDA is forward only: its backward kernels "
            "(K6 _attn_cm_bwd_kernel, K7 _attn_cm_bwd_allheads_kernel) are not ported yet")
    if qkv_t.dtype not in _DTYPES:
        raise TypeError(f"attention_cm kernels take float32 or bfloat16, got {qkv_t.dtype}")
    if qkv_t.dim() != 3 or qkv_t.shape[1] % (3 * num_heads):
        raise ValueError(f"qkv_t must be (B, 3C, N) with C divisible by {num_heads} heads, "
                         f"got {tuple(qkv_t.shape)}")
    D = qkv_t.shape[1] // 3 // num_heads
    if D not in _HEAD_DIMS:
        raise ValueError(f"attention_cm kernels take head_dim in {_HEAD_DIMS}, got {D}")


def window_attention_bias(qkv_t: torch.Tensor, bias: torch.Tensor, num_heads: int,
                          scale: float) -> torch.Tensor:
    """K1: (B, 3C, N <= 128) qkv plus (3C,) bias -> (B, C, N)."""
    _check_cuda(qkv_t, num_heads, bias)
    B, ZC, N = qkv_t.shape
    if N > _WINDOW_MAX_N:
        raise ValueError(f"K1 takes N <= {_WINDOW_MAX_N}, got {N}")
    if bias.shape != (ZC,):
        raise ValueError(f"bias must be ({ZC},), got {tuple(bias.shape)}")
    qkv_t = qkv_t.contiguous()
    bias = bias.to(device=qkv_t.device, dtype=torch.float32).contiguous()
    out = torch.empty((B, ZC // 3, N), device=qkv_t.device, dtype=qkv_t.dtype)
    window_attention_bias_kernel(qkv_t.data_ptr(), bias.data_ptr(), out.data_ptr(), B,
                                 ZC // 3, N, num_heads, float(scale), _DTYPES[qkv_t.dtype])
    return out


def flash_attention_cm(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K2: (B, 3C, N) qkv -> (B, C, N)."""
    _check_cuda(qkv_t, num_heads)
    B, ZC, N = qkv_t.shape
    qkv_t = qkv_t.contiguous()
    out = torch.empty((B, ZC // 3, N), device=qkv_t.device, dtype=qkv_t.dtype)
    flash_attention_cm_kernel(qkv_t.data_ptr(), out.data_ptr(), B, ZC // 3, N, num_heads,
                              float(scale), _DTYPES[qkv_t.dtype])
    return out


def attention_cm(qkv_t: torch.Tensor, num_heads: int, scale: Optional[float] = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over channel-major packed qkv (B, 3C, N) -> (B, C, N), with
    an optional (3C,) qkv bias."""
    B, ZC, N = qkv_t.shape
    if ZC % (3 * num_heads):
        raise ValueError(f"3C = {ZC} is not divisible by 3 x {num_heads} heads")
    if scale is None:
        scale = 1.0 / math.sqrt(ZC // 3 // num_heads)
    if qkv_t.is_cuda and bias is not None and N <= _WINDOW_MAX_N:
        return window_attention_bias(qkv_t, bias, num_heads, scale)
    if bias is not None:
        qkv_t = qkv_t + bias.to(qkv_t.dtype)[:, None]
    if qkv_t.is_cuda:
        return flash_attention_cm(qkv_t, num_heads, scale)
    return attention_cm_plain(qkv_t, num_heads, scale)
