"""Exact softmax attention over channel-major packed qkv (B, 3C, N) -> (B, C, N).

Counterpart of `lwdetr_tpu/ops/flash_attention.py::attention_cm`, with the
same dispatch:

* a (3C,) qkv bias and N <= 128 (the ViT window blocks): K1,
  `csrc/window_attention.cu`, which adds the bias on the loaded panel; its
  backward is K7, `csrc/window_attention_bwd.cu`;
* no bias and N <= 128 (the decoder's self-attention of the 100-query
  preset, eval and train): K9, the case of K1's source that reads no bias;
  its backward is the case of K7's source that reads none, with a launch
  count of its own (`window_attention_bwd_kernel`, "K7nb");
* otherwise the bias, if any, is added inline and K2,
  `csrc/flash_attention.cu`, runs (the ViT global blocks and the decoder's
  self-attention over 300 queries); its backward is K6,
  `csrc/flash_attention_bwd.cu`, which reads the per-row log-sum-exp that K2
  writes when a gradient is needed and forms the row term sum_j p dp itself.

Each forward / backward pair is a `torch.autograd.Function`. On a CUDA tensor
the kernels run, or the call raises; a tensor on the CPU takes the plain
versions, `attention_cm_plain` and `attention_cm_bwd_plain`, which are also
what the kernels are held against on the card.

In bf16 the forward kernels (K1, K2, K9) run on the tensor cores and round
what the JAX kernels round: the softmax weights p = exp(s - max) to bf16
before PV, normalised by the f32 row sum after it, and (K1) the biased panel
once, bf16(x + bf16(bias)). `attention_cm_plain` makes the same roundings on
bf16 inputs, and `bf16_error_bound` is the bound the kernels are held to.
The bf16 backward kernels (K6, K7) round ds and p to bf16 before their
products, and K7 the biased panel once, as the JAX kernels do;
`attention_cm_bwd_plain` rounds alike and `bf16_bwd_error_bound` bounds them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from lwdetr_tpu_torch.ops._build import CudaKernel, load

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
# K9 replaces lwdetr_tpu/ops/flash_attention.py:88 _attn_cm_allheads_kernel
window_attention_kernel = CudaKernel(
    "K9", "window_attention.cu", "lw_window_attention", [_P, _P, _I, _I, _I, _I, _F, _I])
# K2 replaces lwdetr_tpu/ops/flash_attention.py:43 _attn_cm_kernel
flash_attention_cm_kernel = CudaKernel(
    "K2", "flash_attention.cu", "lw_flash_attention_cm",
    [_P, _P, _P, _I, _I, _I, _I, _F, _I])
# K6 replaces lwdetr_tpu/ops/flash_attention.py:287 _attn_cm_bwd_kernel
flash_attention_cm_bwd_kernel = CudaKernel(
    "K6", "flash_attention_bwd.cu", "lw_flash_attention_cm_bwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I])
# K7 replaces lwdetr_tpu/ops/flash_attention.py:347 _attn_cm_bwd_allheads_kernel
window_attention_bias_bwd_kernel = CudaKernel(
    "K7", "window_attention_bwd.cu", "lw_window_attention_bias_bwd",
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I])
# the same TPU kernel serves the forward without a bias (K9); here that is the
# no-bias case of K7's source, counted apart from K7's launches
window_attention_bwd_kernel = CudaKernel(
    "K7nb", "window_attention_bwd.cu", "lw_window_attention_bwd",
    [_P, _P, _P, _I, _I, _I, _I, _F, _I])


def kernel_attributes(kernel: CudaKernel, qkv_t: torch.Tensor, num_heads: int) -> dict:
    """{registers, spill_bytes, shared_bytes} (a thread, a thread, static a
    block; `cudaFuncGetAttributes`) of the kernel that K1, K2, K9, K6, K7 or
    K7nb would launch on this CUDA `qkv_t`: the case of its dtype, head_dim
    and (K1, K2, K9) copy width. K6 launches two passes: its registers are
    the larger and its spills the sum of theirs, with both under "passes"."""
    B, ZC, N = qkv_t.shape
    forward = kernel.name in ("K1", "K2", "K9")
    head = [qkv_t.data_ptr()] if forward else []
    args = head + [B, ZC // 3, N, num_heads, _DTYPES[qkv_t.dtype]]
    symbol = {"K1": "lw_window_attention_attributes", "K9": "lw_window_attention_attributes",
              "K2": "lw_flash_attention_cm_attributes",
              "K6": "lw_flash_attention_cm_bwd_attributes",
              "K7": "lw_window_attention_bwd_attributes",
              "K7nb": "lw_window_attention_bwd_attributes"}.get(kernel.name)
    if symbol is None:
        raise ValueError(f"attributes are exported for K1, K2, K9, K6 and K7, not {kernel.name}")
    fn = getattr(load(kernel.source), symbol)
    if kernel.name in ("K1", "K9", "K7", "K7nb"):
        args.append(int(kernel.name in ("K1", "K7")))
    fn.argtypes = [_P] * len(head) + [_I] * (len(args) - len(head)) + [ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * 6)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{kernel.name} attributes: CUDA error {err}")
    if kernel.name != "K6":
        return {"registers": out[0], "spill_bytes": out[1], "shared_bytes": out[2]}
    passes = [{"registers": out[3 * i], "spill_bytes": out[3 * i + 1],
               "shared_bytes": out[3 * i + 2]} for i in range(2)]
    return {"registers": max(p["registers"] for p in passes),
            "spill_bytes": sum(p["spill_bytes"] for p in passes),
            "shared_bytes": max(p["shared_bytes"] for p in passes), "passes": passes}


def plain_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions work in f32, or in f64 on f64 inputs (gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def attention_cm_plain(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version (counterpart of `_xla_sdpa_cm`): f32 scores,
    exact softmax, result in the input's dtype. On bf16 inputs it rounds as
    the JAX kernel does (`_attn_cm_kernel`, lwdetr_tpu/ops/flash_attention.py:
    52-60): p = exp(s - max) is rounded to bf16 before PV, which sums in f32,
    and the f32 row sum of the unrounded p divides after PV."""
    B, ZC, N = qkv_t.shape
    C = ZC // 3
    D = C // num_heads
    x = qkv_t.to(plain_dtype(qkv_t)).reshape(B, 3, num_heads, D, N)
    q, k, v = x[:, 0], x[:, 1], x[:, 2]  # (B, H, D, N)
    s = torch.einsum("bhdn,bhdm->bhnm", q * scale, k)
    if qkv_t.dtype != torch.bfloat16:
        o = torch.einsum("bhnm,bhdm->bhdn", s.softmax(dim=-1), v)
    else:
        p = (s - s.amax(dim=-1, keepdim=True)).exp()
        o = torch.einsum("bhnm,bhdm->bhdn", p.to(torch.bfloat16).to(p.dtype), v)
        o = o / p.sum(dim=-1)[:, :, None, :]
    return o.reshape(B, C, N).to(qkv_t.dtype)


def bf16_error_bound(qkv_t: torch.Tensor, num_heads: int, scale: float,
                     plain: torch.Tensor) -> torch.Tensor:
    """Element-wise bound on |kernel - plain| for the bf16 forward kernels,
    with `plain` the plain version's output (f32) on the same bf16 `qkv_t`
    (K1: the panel with the bias already added in bf16):

        2e-5 + 2^-8 |plain| + 2^-8 attention(q, k, |v|).

    out = sum_j bf16(p_j) v_j / l: rounding p_j to bf16 moves each term by at
    most 2^-9 p_j |v_j|, so an output by at most 2^-9 sum_j p_j |v_j| / l, the
    attention of |v|. The kernel rounds p at its running row max and rescales
    it in f32 (online softmax), the plain version at the exact max: two
    roundings that differ, a factor 2. The result's own rounding to bf16 is
    half an ulp, at most 2^-9 |out|; 2e-5 covers f32 sums in another order."""
    B, ZC, N = qkv_t.shape
    x = qkv_t.float().reshape(B, 3, ZC // 3, N).clone()
    x[:, 2] = x[:, 2].abs()
    abs_v = attention_cm_plain(x.reshape(B, ZC, N), num_heads, scale)
    return 2e-5 + 2.0 ** -8 * (plain.float().abs() + abs_v)


def _bwd_terms(qkv_t: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float,
               bias: Optional[torch.Tensor], out: Optional[torch.Tensor]):
    """q, k, d(out) (B, H, D, N), p and ds (B, H, N, N) of the attention
    backward, unrounded, in the plain dtype; the biased panel as `attention_cm`
    forms it (in bf16 one rounding of x + bf16(bias))."""
    B, ZC, N = qkv_t.shape
    C = ZC // 3
    D = C // num_heads
    ct = plain_dtype(qkv_t)
    if bias is None:
        x = qkv_t.to(ct)
    elif qkv_t.dtype == torch.bfloat16:
        x = (qkv_t + bias.to(qkv_t.dtype)[:, None]).to(ct)
    else:
        x = qkv_t.to(ct) + bias.to(ct)[:, None]
    x = x.reshape(B, 3, num_heads, D, N)
    q, k, v = x[:, 0], x[:, 1], x[:, 2]  # (B, H, D, N)
    g = dout.to(ct).reshape(B, num_heads, D, N)
    p = torch.einsum("bhdn,bhdm->bhnm", q * scale, k).softmax(dim=-1)
    dp = torch.einsum("bhdn,bhdm->bhnm", g, v)
    if out is None:
        row = (dp * p).sum(dim=-1, keepdim=True)
    else:
        row = (g * out.to(ct).reshape(B, num_heads, D, N)).sum(dim=2)[..., None]
    return q, k, g, p, p * (dp - row) * scale


def attention_cm_bwd_plain(qkv_t: torch.Tensor, dout: torch.Tensor, num_heads: int,
                           scale: float, bias: Optional[torch.Tensor] = None,
                           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the attention backwards (K6, and K7 with or
    without `bias`): d(qkv_t) (B, 3C, N) in qkv_t's dtype from d(out) (B, C, N), by
    the explicit formulas, in f32. With p = softmax(scale q^T k):
    dp = d(out)^T v, ds = p (dp - row) scale, dq = k ds^T, dk = q ds,
    dv = d(out) p. `row` is sum_j p dp, as the JAX kernels and K6 / K7 form
    it, or, given the forward's `out`, sum_d d(out) out (equal in exact
    arithmetic; in bf16 the rounded `out` moves it, see K6's header). The
    gradient of `bias` is the sum of the result over (0, 2).

    On bf16 inputs it rounds as the JAX kernels do (`_attn_cm_bwd_kernel`,
    `_attn_cm_bwd_allheads_kernel`, lwdetr_tpu/ops/flash_attention.py:320-338,
    :376-378): ds and p are rounded to bf16 before the three products, which
    sum in f32, and `row` takes the unrounded p; the biased panel is
    bf16(x + bf16(bias)), one rounding (`_attn_cm_bias_bwd`, :262). Its f32
    path makes none of these roundings."""
    B, ZC, N = qkv_t.shape
    q, k, g, p, ds = _bwd_terms(qkv_t, dout, num_heads, scale, bias, out)
    if qkv_t.dtype == torch.bfloat16:
        ds, p = (t.to(torch.bfloat16).to(p.dtype) for t in (ds, p))
    dq = torch.einsum("bhnm,bhdm->bhdn", ds, k)
    dk = torch.einsum("bhnm,bhdn->bhdm", ds, q)
    dv = torch.einsum("bhnm,bhdn->bhdm", p, g)
    return torch.stack([dq, dk, dv], dim=1).reshape(B, ZC, N).to(qkv_t.dtype)


def bf16_bwd_error_bound(qkv_t: torch.Tensor, dout: torch.Tensor, num_heads: int, scale: float,
                         plain: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element-wise bound on |kernel - plain| for the bf16 backward kernels (K6,
    K7), with `plain` (f32) the plain backward on the same bf16 `qkv_t`,
    `dout` (and `bias`):

        2e-5 max(1, max |plain|) + ulp(plain) + 2^-8 [sum_j |ds| |k|,
                                                      sum_i |ds| |q|,
                                                      sum_i p |d(out)|]

    for dq, dk, dv. dq = sum_j bf16(ds_ij) k_j: rounding ds_ij to bf16 moves
    a term by at most 2^-9 |ds_ij| |k_j|, so dq by at most 2^-9 sum_j |ds| |k|;
    likewise dk, and dv with p. The kernel rounds its own f32 ds and p (p from
    K2's log-sum-exp, ds with another sum order) and the plain version its
    own: two roundings that differ, a factor 2. The result's rounding to bf16
    is half an ulp on either side: one bf16 ulp of |plain| in all,
    2^(floor(log2 |plain|) - 7), between 2^-8 and 2^-7 of |plain|; the first
    term is the f32 tolerance of the backwards (sums in another order)."""
    if qkv_t.dtype != torch.bfloat16:
        raise TypeError(f"the bound is for bf16 inputs, got {qkv_t.dtype}")
    B, ZC, N = qkv_t.shape
    q, k, g, p, ds = _bwd_terms(qkv_t, dout, num_heads, scale, bias, None)
    ads = ds.abs()
    terms = torch.stack([torch.einsum("bhnm,bhdm->bhdn", ads, k.abs()),
                         torch.einsum("bhnm,bhdn->bhdm", ads, q.abs()),
                         torch.einsum("bhnm,bhdn->bhdm", p, g.abs())], dim=1).reshape(B, ZC, N)
    plain = plain.float()
    ulp = torch.exp2(torch.floor(torch.log2(plain.abs().clamp(min=2.0 ** -126))) - 7)
    return 2e-5 * max(1.0, plain.abs().max().item()) + ulp + 2.0 ** -8 * terms


def _check_cuda(qkv_t: torch.Tensor, num_heads: int) -> None:
    if qkv_t.dtype not in _DTYPES:
        raise TypeError(f"attention_cm kernels take float32 or bfloat16, got {qkv_t.dtype}")
    if qkv_t.dim() != 3 or qkv_t.shape[1] % (3 * num_heads):
        raise ValueError(f"qkv_t must be (B, 3C, N) with C divisible by {num_heads} heads, "
                         f"got {tuple(qkv_t.shape)}")
    D = qkv_t.shape[1] // 3 // num_heads
    if D not in _HEAD_DIMS:
        raise ValueError(f"attention_cm kernels take head_dim in {_HEAD_DIMS}, got {D}")


def _check_window(qkv_t: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if qkv_t.shape[2] > _WINDOW_MAX_N:
        raise ValueError(f"K1 / K9 / K7 take N <= {_WINDOW_MAX_N}, got {qkv_t.shape[2]}")
    if bias is not None and bias.shape != (qkv_t.shape[1],):
        raise ValueError(f"bias must be ({qkv_t.shape[1]},), got {tuple(bias.shape)}")


def _f32_bias(bias: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return bias.detach().to(device=like.device, dtype=torch.float32).contiguous()


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd will want a gradient of any of `tensors`."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def window_attention_bias_fwd(qkv_t: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int,
                              scale: float) -> torch.Tensor:
    """K1 launch (K9 when `bias` is None) on a CUDA tensor (the plain version
    on the CPU), outside autograd."""
    if not qkv_t.is_cuda:
        if bias is not None:  # in bf16 one rounding of the sum, as the JAX kernel adds it
            qkv_t = qkv_t + bias.to(qkv_t.dtype)[:, None]
        return attention_cm_plain(qkv_t, num_heads, scale)
    _check_cuda(qkv_t, num_heads)
    _check_window(qkv_t, bias)
    B, ZC, N = qkv_t.shape
    qkv_t = qkv_t.contiguous()
    out = torch.empty((B, ZC // 3, N), device=qkv_t.device, dtype=qkv_t.dtype)
    tail = (B, ZC // 3, N, num_heads, float(scale), _DTYPES[qkv_t.dtype])
    if bias is None:
        window_attention_kernel(qkv_t.data_ptr(), out.data_ptr(), *tail)
    else:
        bias = _f32_bias(bias, qkv_t)
        window_attention_bias_kernel(qkv_t.data_ptr(), bias.data_ptr(), out.data_ptr(), *tail)
    return out


def flash_attention_cm_fwd(qkv_t: torch.Tensor, num_heads: int, scale: float,
                           with_lse: bool = False):
    """K2 launch on a CUDA tensor (the plain version on the CPU), outside
    autograd: (out (B, C, N), lse). `lse` (B, H, N) f32, each row's
    log-sum-exp of the scaled scores in log2 units, is what K6 reads; it is
    None, and not written, unless `with_lse` on a CUDA tensor."""
    if not qkv_t.is_cuda:
        return attention_cm_plain(qkv_t, num_heads, scale), None
    _check_cuda(qkv_t, num_heads)
    B, ZC, N = qkv_t.shape
    qkv_t = qkv_t.contiguous()
    out = torch.empty((B, ZC // 3, N), device=qkv_t.device, dtype=qkv_t.dtype)
    lse = (torch.empty((B, num_heads, N), device=qkv_t.device, dtype=torch.float32)
           if with_lse else None)
    flash_attention_cm_kernel(qkv_t.data_ptr(), out.data_ptr(),
                              None if lse is None else lse.data_ptr(), B, ZC // 3, N,
                              num_heads, float(scale), _DTYPES[qkv_t.dtype])
    return out, lse


class _WindowAttentionBias(torch.autograd.Function):
    """K1 forward, K7 backward; the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, qkv_t, bias, num_heads, scale):
        ctx.save_for_backward(qkv_t, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        return window_attention_bias_fwd(qkv_t, bias, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        qkv_t, bias = ctx.saved_tensors
        dqkv = window_attention_bias_bwd(qkv_t, bias, dout, ctx.num_heads, ctx.scale)
        dbias = None
        if ctx.needs_input_grad[1]:
            # summed in f32 outside the kernel, as the JAX VJP does
            dbias = dqkv.to(plain_dtype(dqkv)).sum(dim=(0, 2)).to(bias.dtype)
        return dqkv, dbias, None, None


class _WindowAttention(torch.autograd.Function):
    """K9 forward, the no-bias case of K7 backward; the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, qkv_t, num_heads, scale):
        ctx.save_for_backward(qkv_t)
        ctx.num_heads, ctx.scale = num_heads, scale
        return window_attention_bias_fwd(qkv_t, None, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        (qkv_t,) = ctx.saved_tensors
        return window_attention_bias_bwd(qkv_t, None, dout, ctx.num_heads, ctx.scale), None, None


class _FlashAttentionCM(torch.autograd.Function):
    """K2 forward (writing the row log-sum-exp), K6 backward; the plain
    versions on CPU tensors."""

    @staticmethod
    def forward(ctx, qkv_t, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        out, lse = flash_attention_cm_fwd(qkv_t, num_heads, scale, with_lse=True)
        ctx.save_for_backward(qkv_t, *(() if lse is None else (lse,)))
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv_t, *lse = ctx.saved_tensors
        return flash_attention_cm_bwd(qkv_t, lse[0] if lse else None, dout,
                                      ctx.num_heads, ctx.scale), None, None


def window_attention_bias(qkv_t: torch.Tensor, bias: torch.Tensor, num_heads: int,
                          scale: float) -> torch.Tensor:
    """K1 (backward K7): (B, 3C, N <= 128) qkv plus (3C,) bias -> (B, C, N)."""
    if not needs_grad(qkv_t, bias):
        return window_attention_bias_fwd(qkv_t, bias, num_heads, scale)
    return _WindowAttentionBias.apply(qkv_t, bias, num_heads, scale)


def window_attention(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K9 (backward: the no-bias case of K7): (B, 3C, N <= 128) qkv -> (B, C, N)."""
    if not needs_grad(qkv_t):
        return window_attention_bias_fwd(qkv_t, None, num_heads, scale)
    return _WindowAttention.apply(qkv_t, num_heads, scale)


def flash_attention_cm(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K2 (backward K6): (B, 3C, N) qkv -> (B, C, N). The row log-sum-exp is
    written only when a backward will read it."""
    if not needs_grad(qkv_t):
        return flash_attention_cm_fwd(qkv_t, num_heads, scale)[0]
    return _FlashAttentionCM.apply(qkv_t, num_heads, scale)


def window_attention_bias_bwd(qkv_t: torch.Tensor, bias: Optional[torch.Tensor],
                              dout: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K7: d(qkv_t) (B, 3C, N <= 128) of `window_attention_bias`, or with `bias`
    None of `window_attention`, from d(out) (B, C, N)."""
    if not qkv_t.is_cuda:
        return attention_cm_bwd_plain(qkv_t, dout, num_heads, scale, bias=bias)
    _check_cuda(qkv_t, num_heads)
    _check_window(qkv_t, bias)
    B, ZC, N = qkv_t.shape
    if dout.shape != (B, ZC // 3, N) or dout.device != qkv_t.device:
        raise ValueError(f"d(out) must be {(B, ZC // 3, N)} on {qkv_t.device}, "
                         f"got {tuple(dout.shape)} on {dout.device}")
    qkv_t = qkv_t.contiguous()
    dout = dout.to(qkv_t.dtype).contiguous()
    dqkv = torch.empty_like(qkv_t)
    tail = (dout.data_ptr(), dqkv.data_ptr(), B, ZC // 3, N, num_heads, float(scale),
            _DTYPES[qkv_t.dtype])
    if bias is None:
        window_attention_bwd_kernel(qkv_t.data_ptr(), *tail)
    else:
        bias = _f32_bias(bias, qkv_t)
        window_attention_bias_bwd_kernel(qkv_t.data_ptr(), bias.data_ptr(), *tail)
    return dqkv


def flash_attention_cm_bwd(qkv_t: torch.Tensor, lse: Optional[torch.Tensor], dout: torch.Tensor,
                           num_heads: int, scale: float) -> torch.Tensor:
    """K6: d(qkv_t) (B, 3C, N) of `flash_attention_cm` from d(out) (B, C, N) and
    the row log-sum-exp `lse` (B, H, N) that K2 wrote (None on the CPU)."""
    if not qkv_t.is_cuda:
        return attention_cm_bwd_plain(qkv_t, dout, num_heads, scale)
    _check_cuda(qkv_t, num_heads)
    B, ZC, N = qkv_t.shape
    for name, t, shape in (("d(out)", dout, (B, ZC // 3, N)), ("lse", lse, (B, num_heads, N))):
        if t is None or t.shape != shape or t.device != qkv_t.device:
            raise ValueError(f"{name} must be {shape} on {qkv_t.device}, got "
                             f"{None if t is None else (tuple(t.shape), t.device)}")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    qkv_t = qkv_t.contiguous()
    dout = dout.to(qkv_t.dtype).contiguous()
    lse = lse.contiguous()
    dqkv = torch.empty_like(qkv_t)
    delta = torch.empty_like(lse)  # sum_j p dp per row: pass 1 writes it, pass 2 reads it
    flash_attention_cm_bwd_kernel(qkv_t.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                                  dqkv.data_ptr(), delta.data_ptr(), B, ZC // 3, N, num_heads,
                                  float(scale), _DTYPES[qkv_t.dtype])
    return dqkv


def attention_cm(qkv_t: torch.Tensor, num_heads: int, scale: Optional[float] = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over channel-major packed qkv (B, 3C, N) -> (B, C, N), with
    an optional (3C,) qkv bias. Differentiable in qkv_t and bias."""
    B, ZC, N = qkv_t.shape
    if ZC % (3 * num_heads):
        raise ValueError(f"3C = {ZC} is not divisible by 3 x {num_heads} heads")
    if scale is None:
        scale = 1.0 / math.sqrt(ZC // 3 // num_heads)
    if N <= _WINDOW_MAX_N:
        if bias is not None:
            return window_attention_bias(qkv_t, bias, num_heads, scale)
        return window_attention(qkv_t, num_heads, scale)
    if bias is not None:
        qkv_t = qkv_t + bias.to(qkv_t.dtype)[:, None]
    return flash_attention_cm(qkv_t, num_heads, scale)
