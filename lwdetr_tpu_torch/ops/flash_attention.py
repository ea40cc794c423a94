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

Each forward kernel is an operator of the `lwdetr` namespace
(`torch.ops.lwdetr.window_attention_bias`, `.window_attention`,
`.flash_attention_cm`) with a fake version and its backward kernel as the
autograd formula, so that `torch.export` keeps it as one node. On a CUDA
tensor the kernels run, or the call raises; a tensor on the CPU takes the
plain versions, `attention_cm_plain` and `attention_cm_bwd_plain`, which are
also what the kernels are held against on the card.

Head dims: the kernels have cases for 16, 32 and 64 (the ViT's, on the
tensor cores in bf16) and a wide case for every multiple of 64 from 128 up
(`csrc/attention_wide.cuh`, tensor cores in both dtypes: the decoder's heads
when `--hidden_dim` / `--sa_nheads` make them wider, e.g. 256 / 2 or
512 / 1), which K2, K9, K6 and K7nb take; `attention_cm` zero-pads any other
head dim to the next case (`attention_cm_padded`, `padded_head_dim`), with no
upper limit. K1 / K7 with the ViT's qkv bias keep 64 as their largest (every
ViT has 12 heads of at most 64 channels).

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
from typing import Optional, Tuple

import torch

from lwdetr_tpu_torch.ops._build import CudaKernel, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims of the kernels' cases: 16, 32, 64 (tensor cores in bf16), and
# the wide case (`csrc/attention_wide.cuh`) at every multiple of _WIDE_STEP
# from _WIDE_MIN up, which K2 / K6 / K9 / K7nb take for the decoder's wider heads
_HEAD_DIMS = (16, 32, 64)
_WIDE_MIN = 128
_WIDE_STEP = 64
_WINDOW_MAX_N = 128
_BIAS_MAX_HEAD_DIM = 64
_BIAS_REFUSAL = ("K1 / K7 (the ViT's window attention with its qkv bias) take head_dim up to "
                 "64: every ViT of the JAX package has 12 heads of at most 64 channels, got {}")

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
    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I])


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


# the plain attention forms the scores of this many (image, head) pairs at a
# time when all of them would exceed _PLAIN_SCORES values (long padded maps on
# the CPU: 4624 tokens x 12 heads x 2 images would be 2 GB at once)
_PLAIN_SCORES = 1 << 26


def attention_cm_plain(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch version (counterpart of `_xla_sdpa_cm`): f32 scores,
    exact softmax, result in the input's dtype. On bf16 inputs it rounds as
    the JAX kernel does (`_attn_cm_kernel`, lwdetr_tpu/ops/flash_attention.py:
    52-60): p = exp(s - max) is rounded to bf16 before PV, which sums in f32,
    and the f32 row sum of the unrounded p divides after PV. The scores of
    many long rows are formed a few (image, head) pairs at a time."""
    B, ZC, N = qkv_t.shape
    C = ZC // 3
    D = C // num_heads
    x = qkv_t.to(plain_dtype(qkv_t)).reshape(B, 3, num_heads, D, N)
    q, k, v = (x[:, i].reshape(B * num_heads, D, N) for i in range(3))
    step = max(1, _PLAIN_SCORES // (N * N))
    outs = []
    for i in range(0, B * num_heads, step):
        qi, ki, vi = q[i:i + step], k[i:i + step], v[i:i + step]
        s = torch.einsum("zdn,zdm->znm", qi * scale, ki)
        if qkv_t.dtype != torch.bfloat16:
            outs.append(torch.einsum("znm,zdm->zdn", s.softmax(dim=-1), vi))
        else:
            p = (s - s.amax(dim=-1, keepdim=True)).exp()
            o = torch.einsum("znm,zdm->zdn", p.to(torch.bfloat16).to(p.dtype), vi)
            outs.append(o / p.sum(dim=-1)[:, None, :])
    return torch.cat(outs).reshape(B, C, N).to(qkv_t.dtype)


def attention_lse_plain(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Each row's log-sum-exp of the f32 scaled scores, in log2 units, (B, H, N)
    f32: what K2 writes for K6, a few (image, head) pairs at a time."""
    B, ZC, N = qkv_t.shape
    D = ZC // 3 // num_heads
    x = qkv_t.float().reshape(B, 3, num_heads, D, N)
    q, k = (x[:, i].reshape(B * num_heads, D, N) for i in range(2))
    step = max(1, _PLAIN_SCORES // (N * N))
    lse = [torch.logsumexp(torch.einsum("zdn,zdm->znm", q[i:i + step] * scale, k[i:i + step]),
                           dim=-1) for i in range(0, B * num_heads, step)]
    return torch.cat(lse).reshape(B, num_heads, N) / math.log(2.0)


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


def is_wide_head_dim(head_dim: int) -> bool:
    """Whether the wide case (`csrc/attention_wide.cuh`) takes this head_dim:
    a multiple of 64, from 128 up (`lw_wide::takes`)."""
    return head_dim >= _WIDE_MIN and head_dim % _WIDE_STEP == 0


def has_kernel_case(head_dim: int) -> bool:
    """Whether a kernel case takes this head_dim unpadded."""
    return head_dim in _HEAD_DIMS or is_wide_head_dim(head_dim)


def _check_cuda(qkv_t: torch.Tensor, num_heads: int) -> None:
    if qkv_t.dtype not in _DTYPES:
        raise TypeError(f"attention_cm kernels take float32 or bfloat16, got {qkv_t.dtype}")
    if qkv_t.dim() != 3 or qkv_t.shape[1] % (3 * num_heads):
        raise ValueError(f"qkv_t must be (B, 3C, N) with C divisible by {num_heads} heads, "
                         f"got {tuple(qkv_t.shape)}")
    D = qkv_t.shape[1] // 3 // num_heads
    if not has_kernel_case(D):
        raise ValueError(f"attention_cm kernels take head_dim in {_HEAD_DIMS} or a multiple of "
                         f"{_WIDE_STEP} from {_WIDE_MIN} up, got {D} (attention_cm zero-pads a "
                         f"head_dim to the next of them)")


def _check_window(qkv_t: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if qkv_t.shape[2] > _WINDOW_MAX_N:
        raise ValueError(f"K1 / K9 / K7 take N <= {_WINDOW_MAX_N}, got {qkv_t.shape[2]}")
    if bias is not None and bias.shape != (qkv_t.shape[1],):
        raise ValueError(f"bias must be ({qkv_t.shape[1]},), got {tuple(bias.shape)}")


def _check_bias_head_dim(qkv_t: torch.Tensor, bias: Optional[torch.Tensor],
                         num_heads: int) -> None:
    D = qkv_t.shape[1] // 3 // num_heads
    if bias is not None and D > _BIAS_MAX_HEAD_DIM:
        raise ValueError(_BIAS_REFUSAL.format(D))


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
    _check_bias_head_dim(qkv_t, bias, num_heads)
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
    None, and not written, unless `with_lse` (on the CPU: `attention_lse_plain`)."""
    if not qkv_t.is_cuda:
        lse = attention_lse_plain(qkv_t, num_heads, scale) if with_lse else None
        return attention_cm_plain(qkv_t, num_heads, scale), lse
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


# The kernels as operators of the `lwdetr` namespace (torch.library), so that
# `torch.export` traces each forward as one opaque node (its fake version gives
# the output's shape and dtype) and an exported graph runs the kernel, and so
# that `torch.utils.flop_counter` sees every launch, the backward ones too
# (`utils/benchmark.py`). Eager calls take the same operators. Each forward
# operator's implementation calls the module's `*_fwd` function, looked up
# when it runs, which launches the kernel on a CUDA tensor or raises, and runs
# the plain version on a CPU tensor; each autograd formula calls a backward
# operator (`*_bwd`: K7, K7nb, K6), whose implementation calls the module's
# `*_bwd` function likewise.


@torch.library.custom_op("lwdetr::window_attention_bias", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _window_attention_bias_op(qkv_t: torch.Tensor, bias: torch.Tensor, num_heads: int,
                              scale: float) -> torch.Tensor:
    return window_attention_bias_fwd(qkv_t, bias, num_heads, scale)


@torch.library.custom_op("lwdetr::window_attention", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _window_attention_op(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    return window_attention_bias_fwd(qkv_t, None, num_heads, scale)


@torch.library.custom_op("lwdetr::flash_attention_cm", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _flash_attention_cm_op(qkv_t: torch.Tensor, num_heads: int, scale: float,
                           with_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    out, lse = flash_attention_cm_fwd(qkv_t, num_heads, scale, with_lse)
    return out, (qkv_t.new_empty((0,), dtype=torch.float32) if lse is None else lse)


def _attention_out_fake(qkv_t: torch.Tensor) -> torch.Tensor:
    B, ZC, N = qkv_t.shape
    return qkv_t.new_empty((B, ZC // 3, N))


@_window_attention_bias_op.register_fake
def _(qkv_t, bias, num_heads, scale):
    return _attention_out_fake(qkv_t)


@_window_attention_op.register_fake
def _(qkv_t, num_heads, scale):
    return _attention_out_fake(qkv_t)


@_flash_attention_cm_op.register_fake
def _(qkv_t, num_heads, scale, with_lse):
    B, _, N = qkv_t.shape
    lse = qkv_t.new_empty((B, num_heads, N) if with_lse else (0,), dtype=torch.float32)
    return _attention_out_fake(qkv_t), lse


@torch.library.custom_op("lwdetr::window_attention_bias_bwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _window_attention_bias_bwd_op(qkv_t: torch.Tensor, bias: torch.Tensor, dout: torch.Tensor,
                                  num_heads: int, scale: float) -> torch.Tensor:
    return window_attention_bias_bwd(qkv_t, bias, dout, num_heads, scale)


@torch.library.custom_op("lwdetr::window_attention_bwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _window_attention_bwd_op(qkv_t: torch.Tensor, dout: torch.Tensor, num_heads: int,
                             scale: float) -> torch.Tensor:
    return window_attention_bias_bwd(qkv_t, None, dout, num_heads, scale)


@torch.library.custom_op("lwdetr::flash_attention_cm_bwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _flash_attention_cm_bwd_op(qkv_t: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                               num_heads: int, scale: float) -> torch.Tensor:
    # the CPU's plain backward reads no log-sum-exp
    return flash_attention_cm_bwd(qkv_t, lse if qkv_t.is_cuda else None, dout, num_heads, scale)


@_window_attention_bias_bwd_op.register_fake
def _(qkv_t, bias, dout, num_heads, scale):
    return torch.empty_like(qkv_t)


@_window_attention_bwd_op.register_fake
def _(qkv_t, dout, num_heads, scale):
    return torch.empty_like(qkv_t)


@_flash_attention_cm_bwd_op.register_fake
def _(qkv_t, lse, dout, num_heads, scale):
    return torch.empty_like(qkv_t)


def _save_attention(ctx, inputs, output):
    """K1 / K9: the inputs and (num_heads, scale) for the backward."""
    ctx.save_for_backward(*(t for t in inputs if isinstance(t, torch.Tensor)))
    ctx.num_heads, ctx.scale = inputs[-2:]


def _window_attention_bias_backward(ctx, dout):
    """K7: d(qkv_t) and, summed in f32 outside the kernel as the JAX VJP does, d(bias)."""
    qkv_t, bias = ctx.saved_tensors
    dqkv = torch.ops.lwdetr.window_attention_bias_bwd(qkv_t, bias, dout, ctx.num_heads, ctx.scale)
    dbias = None
    if ctx.needs_input_grad[1]:
        dbias = dqkv.to(plain_dtype(dqkv)).sum(dim=(0, 2)).to(bias.dtype)
    return dqkv, dbias, None, None


def _window_attention_backward(ctx, dout):
    """K7nb, the no-bias case of K7."""
    (qkv_t,) = ctx.saved_tensors
    return torch.ops.lwdetr.window_attention_bwd(qkv_t, dout, ctx.num_heads, ctx.scale), None, None


def _save_flash_attention(ctx, inputs, output):
    qkv_t, num_heads, scale, _ = inputs
    ctx.mark_non_differentiable(output[1])
    ctx.save_for_backward(qkv_t, output[1])
    ctx.num_heads, ctx.scale = num_heads, scale


def _flash_attention_backward(ctx, dout, _dlse):
    """K6, from the row log-sum-exp K2 wrote (the CPU's plain backward reads none)."""
    qkv_t, lse = ctx.saved_tensors
    return (torch.ops.lwdetr.flash_attention_cm_bwd(qkv_t, lse, dout, ctx.num_heads, ctx.scale),
            None, None, None)


_window_attention_bias_op.register_autograd(_window_attention_bias_backward,
                                            setup_context=_save_attention)
_window_attention_op.register_autograd(_window_attention_backward, setup_context=_save_attention)
_flash_attention_cm_op.register_autograd(_flash_attention_backward,
                                         setup_context=_save_flash_attention)


def window_attention_bias(qkv_t: torch.Tensor, bias: torch.Tensor, num_heads: int,
                          scale: float) -> torch.Tensor:
    """K1 (backward K7): (B, 3C, N <= 128) qkv plus (3C,) bias -> (B, C, N)."""
    return torch.ops.lwdetr.window_attention_bias(qkv_t, bias, int(num_heads), float(scale))


def window_attention(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K9 (backward: the no-bias case of K7): (B, 3C, N <= 128) qkv -> (B, C, N)."""
    return torch.ops.lwdetr.window_attention(qkv_t, int(num_heads), float(scale))


def flash_attention_cm(qkv_t: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K2 (backward K6): (B, 3C, N) qkv -> (B, C, N). The row log-sum-exp is
    written only when a backward will read it."""
    return torch.ops.lwdetr.flash_attention_cm(qkv_t, int(num_heads), float(scale),
                                               needs_grad(qkv_t))[0]


def window_attention_bias_bwd(qkv_t: torch.Tensor, bias: Optional[torch.Tensor],
                              dout: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """K7: d(qkv_t) (B, 3C, N <= 128) of `window_attention_bias`, or with `bias`
    None of `window_attention`, from d(out) (B, C, N)."""
    if not qkv_t.is_cuda:
        return attention_cm_bwd_plain(qkv_t, dout, num_heads, scale, bias=bias)
    _check_cuda(qkv_t, num_heads)
    _check_window(qkv_t, bias)
    _check_bias_head_dim(qkv_t, bias, num_heads)
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
        # the wide case takes each row's log-sum-exp and row term into this scratch
        stats = (torch.empty((2, B, num_heads, N), device=qkv_t.device, dtype=torch.float32)
                 if is_wide_head_dim(ZC // 3 // num_heads) else None)
        window_attention_bwd_kernel(qkv_t.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                                    None if stats is None else stats.data_ptr(), *tail[2:])
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


def padded_head_dim(head_dim: int) -> int:
    """The head_dim of the kernel case a head_dim takes: the next of 16, 32,
    64, and above 64 the next multiple of 64 (80 -> 128, 129 -> 192, 2112 ->
    2112). No head is too wide: the wide case keeps nothing that grows with
    the head_dim."""
    for d in _HEAD_DIMS:
        if head_dim <= d:
            return d
    return max(_WIDE_MIN, -(-head_dim // _WIDE_STEP) * _WIDE_STEP)


def _pad_heads(t: torch.Tensor, num_heads: int, head_dim: int, padded: int) -> torch.Tensor:
    """(..., 3C, N) or (3C,) in q / k / v, head, channel order -> each head's
    channels zero-padded from head_dim to `padded` (differentiable: the
    gradient of the padding is the slice back)."""
    lead, trail = t.shape[:-2] if t.dim() > 1 else (), t.shape[-1:] if t.dim() > 1 else ()
    heads = t.reshape(*lead, 3, num_heads, head_dim, *trail)
    pad = [0, 0] * len(trail) + [0, padded - head_dim]
    return torch.nn.functional.pad(heads, pad).reshape(*lead, 3 * num_heads * padded, *trail)


def attention_cm_padded(qkv_t: torch.Tensor, num_heads: int, scale: float,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`attention_cm` at a head_dim that no kernel case has: q, k, v (and the
    bias) zero-padded along head_dim to the next case (`padded_head_dim`),
    the original `scale`, the output sliced back. Zero channels add exact
    zeros to q.k and to p.v, so the function is unchanged; autograd slices
    d(qkv) and d(bias) back through the padding. A bias with N <= 128 (K1)
    takes no head_dim above 64."""
    B, ZC, N = qkv_t.shape
    D = ZC // 3 // num_heads
    Dp = padded_head_dim(D)
    if bias is not None and N <= _WINDOW_MAX_N and Dp > _BIAS_MAX_HEAD_DIM:
        raise ValueError(_BIAS_REFUSAL.format(D))
    qkv_p = _pad_heads(qkv_t, num_heads, D, Dp)
    bias_p = None if bias is None else _pad_heads(bias, num_heads, D, Dp)
    out = attention_cm(qkv_p, num_heads, scale, bias_p)
    return out.reshape(B, num_heads, Dp, N)[:, :, :D].reshape(B, num_heads * D, N)


def attention_cm(qkv_t: torch.Tensor, num_heads: int, scale: Optional[float] = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over channel-major packed qkv (B, 3C, N) -> (B, C, N), with
    an optional (3C,) qkv bias. Differentiable in qkv_t and bias. On a CUDA
    tensor a head_dim that no kernel case takes is zero-padded to one
    (`attention_cm_padded`)."""
    B, ZC, N = qkv_t.shape
    if ZC % (3 * num_heads):
        raise ValueError(f"3C = {ZC} is not divisible by 3 x {num_heads} heads")
    D = ZC // 3 // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if qkv_t.is_cuda and not has_kernel_case(D):
        return attention_cm_padded(qkv_t, num_heads, scale, bias)
    if N <= _WINDOW_MAX_N:
        if bias is not None:
            return window_attention_bias(qkv_t, bias, num_heads, scale)
        return window_attention(qkv_t, num_heads, scale)
    if bias is not None:
        qkv_t = qkv_t + bias.to(qkv_t.dtype)[:, None]
    return flash_attention_cm(qkv_t, num_heads, scale)
