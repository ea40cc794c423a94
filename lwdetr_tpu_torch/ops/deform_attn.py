"""Multi-scale deformable attention sampling, in three value layouts.

Bilinear sampling with ``F.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=False)`` semantics, weighted and summed over levels and points:

* `ms_deform_attn_cm`, counterpart of
  `lwdetr_tpu/ops/deform_attn.py::ms_deform_attn_cm`: channel-major value_t
  (B, C, Len_in) -> (B, C, Len_q). On CUDA tensors K3 (`csrc/deform_attn.cu`),
  backward K8 (`csrc/deform_attn_bwd.cu`).
* `ms_deform_attn_sep_panels`, counterpart of
  `lwdetr_tpu/ops/deform_attn.py::ms_deform_attn_sep_panels`: one head-major
  panel (B, H, H_l, W_l * D) per level -> row-major (B, Len_q, C). On CUDA
  tensors K4 (`csrc/deform_attn_sep.cu`), backward K5
  (`csrc/deform_attn_sep_bwd.cu`).
* `ms_deform_attn`, counterpart of
  `lwdetr_tpu/ops/deform_attn.py::ms_deform_attn_pallas`: row-major value
  (B, Len_in, H, D) -> (B, Len_q, C), the contract of the reference's CUDA
  op. On CUDA tensors K10, forward and backward: the row-major cases of K4's
  and K5's sources, each with its own entry symbol and launch count.

Each forward kernel is an operator of the `lwdetr` namespace
(`torch.ops.lwdetr.ms_deform_attn_cm`, `.ms_deform_attn_sep_panels`,
`.ms_deform_attn`; see "operators" below) with a fake version and its
backward kernel as the autograd formula; every backward gives the gradients
of the values, the sampling locations and the attention weights. The
kernels are direct bilinear gathers (K3 and K8 from the head's map staged
in shared memory; K4 and K10 from a table of each point's clamped
corner addresses and weights that a CTA forms once in shared memory, then
with the loads of two or four points in flight, no branch between them;
`sep_route` reports their route); the backwards scatter d(value) with one f32
vector reduction per corner and 4 channels (K8 into a position-major scratch
that it turns channel-major). On CUDA
tensors they launch or the call raises; tensors on the CPU take the plain
versions (`*_plain`, `*_bwd_plain`), the counterparts of the JAX gather
formulation `ms_deform_attn`. In bf16 the forwards, and the panel backward,
round where the JAX package's kernels round (see "bf16" below), not once at
the end; the f32 paths are the plain f32 formulas.

Head dims: K4, K5, K10 and K10b take multiples of 8 up to 64, K8 multiples
of 4 up to 128, K3 any. On CUDA tensors the public wrappers bring any other
head dim to them (`*_split`): each head's channels zero-padded and split
into groups (`head_groups`) that sample as heads of their own with the head's
points and weights; channels never mix, so the result is exact, and autograd
sums the groups' d(loc) and d(weights).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from lwdetr_tpu_torch.ops._build import CudaKernel, load
from lwdetr_tpu_torch.ops.flash_attention import needs_grad, plain_dtype

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_LEVELS = 4

_P = ctypes.c_void_p
_I = ctypes.c_int

# K3 replaces lwdetr_tpu/ops/deform_attn.py:444 _deform_cm_kernel
deform_attn_cm_kernel = CudaKernel(
    "K3", "deform_attn.cu", "lw_deform_attn_cm",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int), _I])
# K4 replaces lwdetr_tpu/ops/deform_attn.py:853 _sep_kernel
deform_attn_sep_kernel = CudaKernel(
    "K4", "deform_attn_sep.cu", "lw_deform_attn_sep",
    [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), _P, _P, _P,
     _I, _I, _I, _I, _I, _I, _I])
# K5 replaces lwdetr_tpu/ops/deform_attn.py:1105 _sep_bwd_kernel (and the VJP of _prep_separable)
deform_attn_sep_bwd_kernel = CudaKernel(
    "K5", "deform_attn_sep_bwd.cu", "lw_deform_attn_sep_bwd",
    [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
     ctypes.POINTER(ctypes.c_int), _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I])
# K8 replaces lwdetr_tpu/ops/deform_attn.py:480 _dvalue_cm_kernel and :509 _dweight_cm_kernel
# (and the VJP of _prep_indices_weights_lanes)
deform_attn_cm_bwd_kernel = CudaKernel(
    "K8", "deform_attn_bwd.cu", "lw_deform_attn_cm_bwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_int),
     _I])
# K10 replaces lwdetr_tpu/ops/deform_attn.py:149 _deform_kernel
deform_attn_rowmajor_kernel = CudaKernel(
    "K10", "deform_attn_sep.cu", "lw_deform_attn_rowmajor",
    [_P, ctypes.POINTER(ctypes.c_int), _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I])
# K10's backward replaces lwdetr_tpu/ops/deform_attn.py:213 _dvalue_kernel and :243
# _dweight_kernel (and the VJP of _prep_indices_weights)
deform_attn_rowmajor_bwd_kernel = CudaKernel(
    "K10b", "deform_attn_sep_bwd.cu", "lw_deform_attn_rowmajor_bwd",
    [_P, _P, ctypes.POINTER(ctypes.c_int), _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I])
# head dims the panel and row-major kernels take, forwards (K4, K10) and
# backwards (K5, K10b): every multiple of 8 up to 64 (a thread's 16-byte run
# of channels is 4 f32 or 8 bf16); K8: every multiple of 4 up to 128. The
# wrappers bring any other head dim to these (`head_groups`), never to a
# plain version.
_SEP_HEAD_DIMS = tuple(range(8, 65, 8))
_SEP_BWD_HEAD_DIMS = _SEP_HEAD_DIMS
_SEP_SPLIT = (8, 64)  # (multiple, largest) of a group's channels for K4 / K5 / K10 / K10b
_CM_BWD_SPLIT = (4, 128)  # for K8


def head_groups(head_dim: int, multiple: int, largest: int) -> Tuple[int, int]:
    """(G, Dg): the split of a head's `head_dim` channels into G groups of Dg
    channels, Dg a multiple of `multiple` at most `largest`, G x Dg >= head_dim
    (the excess zero channels). Sampling never mixes channels, so each group
    samples as a head of its own with the head's points and weights."""
    groups = -(-head_dim // largest)
    per = -(-head_dim // groups)
    return groups, -(-per // multiple) * multiple


def _groups_of(t: torch.Tensor, dim: int, groups: int, per: int) -> torch.Tensor:
    """t with the head-channel axis `dim` zero-padded to groups x per and split
    into (groups, per) there (differentiable: the gradient slices back)."""
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, groups * per - t.shape[dim]]
    t = torch.nn.functional.pad(t, pad)
    return t.reshape(*t.shape[:dim], groups, per, *t.shape[dim + 1:])


def _repeat_heads(loc: torch.Tensor, weights: torch.Tensor, groups: int):
    """loc (B, Q, H, L, P, 2) and weights (B, Q, H, L, P) with each head taken
    `groups` times in a row; autograd sums their gradients over the groups."""
    return loc.repeat_interleave(groups, dim=2), weights.repeat_interleave(groups, dim=2)


def _merge_groups_rowmajor(out: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, Q, H x G x Dg) -> (B, Q, H x head_dim): each head's first head_dim channels."""
    B, Q, _ = out.shape
    return out.reshape(B, Q, heads, -1)[..., :head_dim].reshape(B, Q, heads * head_dim)


def sampling_offsets_init_bias(n_heads: int, n_levels: int, n_points: int) -> torch.Tensor:
    """Initial bias of the sampling-offset projection: head h points along
    angle 2 pi h / n_heads, normalized to the unit Chebyshev ball, scaled by
    point index (i + 1). Returns (n_heads * n_levels * n_points * 2,) f32."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


def ms_deform_attn_cm_plain(value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                            loc: torch.Tensor, weights: torch.Tensor,
                            n_heads: int) -> torch.Tensor:
    """Plain PyTorch version: four corner gathers per level, f32 sums,
    result in value_t's dtype. On bf16 values it rounds as `_deform_cm_kernel`
    does (`merged_corner_weights_plain`)."""
    B, C, _ = value_t.shape
    _, Q, H, L, P, _ = loc.shape
    D = C // n_heads
    if value_t.dtype == torch.bfloat16:
        v = value_t.reshape(B, n_heads, D, -1).transpose(2, 3)  # (B, H, Len_in, D)
        out = _merged_sample_bf16(v, spatial_shapes, loc, weights)  # (B, H, Q, D)
        return out.permute(0, 1, 3, 2).reshape(B, C, Q)
    ct = plain_dtype(value_t)
    val = value_t.to(ct).reshape(B, n_heads, D, -1)
    loc = loc.to(ct)
    weights = weights.to(ct)
    out = torch.zeros((B, n_heads, D, Q), device=value_t.device, dtype=ct)
    start = 0
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        v_l = val[..., start:start + Hl * Wl]  # (B, H, D, HW)
        start += Hl * Wl
        px = loc[:, :, :, lvl, :, 0] * Wl - 0.5  # (B, Q, H, P)
        py = loc[:, :, :, lvl, :, 1] * Hl - 0.5
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = px - x0
        fy = py - y0
        x0 = x0.long()
        y0 = y0.long()
        aw = weights[:, :, :, lvl]  # (B, Q, H, P)
        for dy, dx, cw in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
            idx = yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)  # (B, Q, H, P)
            idx = idx.permute(0, 2, 1, 3).reshape(B, n_heads, 1, Q * P).expand(-1, -1, D, -1)
            g = torch.gather(v_l, 3, idx).reshape(B, n_heads, D, Q, P)
            coef = (cw * valid * aw).permute(0, 2, 1, 3)  # (B, H, Q, P)
            out = out + torch.einsum("bhqp,bhdqp->bhdq", coef, g)
    return out.reshape(B, C, Q).to(value_t.dtype)


def _check_cuda(value_t, spatial_shapes, loc, weights, n_heads):
    if value_t.dtype not in _DTYPES:
        raise TypeError(f"K3 / K8 take float32 or bfloat16 values, got {value_t.dtype}")
    B, C, len_in = value_t.shape
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2] != n_heads or loc.shape[-1] != 2:
        raise ValueError(f"loc must be (B, Q, {n_heads}, L, P, 2), got {tuple(loc.shape)}")
    if weights.shape != loc.shape[:-1]:
        raise ValueError(f"weights must be {tuple(loc.shape[:-1])}, got {tuple(weights.shape)}")
    if not 1 <= len(spatial_shapes) <= _MAX_LEVELS or loc.shape[3] != len(spatial_shapes):
        raise ValueError(f"K3 / K8 take 1..{_MAX_LEVELS} levels matching loc, "
                         f"got {len(spatial_shapes)}")
    if C % n_heads or sum(h * w for h, w in spatial_shapes) != len_in:
        raise ValueError("value_t channels or length do not match heads / spatial_shapes")
    if not (value_t.device == loc.device == weights.device):
        raise ValueError("value_t, loc and weights must be on one device")


def _level_starts(spatial_shapes):
    """The host array the channel-major kernels take: (h, w, start) per level."""
    levels = (ctypes.c_int * (3 * len(spatial_shapes)))()
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        levels[3 * lvl:3 * lvl + 3] = [h, w, start]
        start += h * w
    return levels


def _int_shapes(spatial_shapes):
    return [(int(h), int(w)) for h, w in spatial_shapes]


def ms_deform_attn_cm_fwd(value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                          loc: torch.Tensor, weights: torch.Tensor, n_heads: int) -> torch.Tensor:
    """K3 launch on CUDA tensors (the plain version on the CPU), outside autograd."""
    if not value_t.is_cuda:
        return ms_deform_attn_cm_plain(value_t, spatial_shapes, loc, weights, n_heads)
    _check_cuda(value_t, spatial_shapes, loc, weights, n_heads)
    B, C, len_in = value_t.shape
    _, Q, _, L, P, _ = loc.shape
    value_t = value_t.contiguous()
    loc = loc.to(torch.float32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    out = torch.empty((B, C, Q), device=value_t.device, dtype=value_t.dtype)
    deform_attn_cm_kernel(value_t.data_ptr(), loc.data_ptr(), weights.data_ptr(),
                          out.data_ptr(), B, C, len_in, Q, n_heads, L, P,
                          _level_starts(spatial_shapes), _DTYPES[value_t.dtype])
    return out


def _cm_panels(value_t: torch.Tensor, spatial_shapes, n_heads: int):
    """Channel-major (B, C, Len_in) as per-level panels (B, H, H_l, W_l * D)."""
    B, C, _ = value_t.shape
    v = value_t.reshape(B, n_heads, C // n_heads, -1)
    panels, start = [], 0
    for h, w in spatial_shapes:
        panels.append(v[..., start:start + h * w].transpose(2, 3).reshape(B, n_heads, h, -1))
        start += h * w
    return panels


def ms_deform_attn_cm_bwd_plain(value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                                loc: torch.Tensor, weights: torch.Tensor, dout: torch.Tensor,
                                n_heads: int):
    """Plain PyTorch version of K8: (d(value_t), d(loc), d(weights)) of
    `ms_deform_attn_cm` from d(out) (B, C, Q), by the explicit formulas of
    `ms_deform_attn_sep_panels_bwd_plain` on the same values regrouped. On bf16
    values d(value_t) is formed as `_dvalue_cm_kernel` forms it: the merged
    corner weights of a position rounded to bf16 (`merged_corner_weights_plain`,
    as the forward), times the bf16 d(out), summed in f32 and rounded once."""
    B, C, len_in = value_t.shape
    dvals, dloc, dw = _sep_panels_bwd_formulas(
        _cm_panels(value_t, spatial_shapes, n_heads), spatial_shapes, loc, weights,
        dout.transpose(1, 2))
    D = C // n_heads
    if value_t.dtype == torch.bfloat16:
        Q = loc.shape[1]
        idx, w = merged_corner_weights_plain(spatial_shapes, loc, weights)  # (B, Q, H, J)
        J = idx.shape[-1]
        g = dout.to(torch.bfloat16).float().reshape(B, n_heads, D, Q).transpose(2, 3)
        terms = w.permute(0, 2, 1, 3)[..., None] * g[:, :, :, None, :]  # (B, H, Q, J, D)
        dv = torch.zeros((B, n_heads, len_in, D), device=value_t.device, dtype=torch.float32)
        pos = idx.clamp(min=0).permute(0, 2, 1, 3).reshape(B, n_heads, Q * J, 1)
        dv.scatter_add_(2, pos.expand(-1, -1, -1, D), terms.reshape(B, n_heads, Q * J, D))
        return dv.transpose(2, 3).reshape(B, C, len_in).to(value_t.dtype), dloc, dw
    dvalue_t = torch.cat([dv.reshape(B, n_heads, -1, D).transpose(2, 3) for dv in dvals], dim=3)
    return dvalue_t.reshape(B, C, len_in), dloc, dw


def ms_deform_attn_cm_bwd(value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                          loc: torch.Tensor, weights: torch.Tensor, dout: torch.Tensor,
                          n_heads: int):
    """K8: (d(value_t), d(loc), d(weights)) of `ms_deform_attn_cm` from d(out)
    (B, C, Q). d(value_t) is summed with f32 vector reductions, in no fixed
    order, into a position-major scratch, which the same launch turns
    channel-major in value_t's dtype (for bf16 rounded once from the f32
    sums). Head dims a multiple of 4, at most 128."""
    if not value_t.is_cuda:
        return ms_deform_attn_cm_bwd_plain(value_t, spatial_shapes, loc, weights, dout, n_heads)
    _check_cuda(value_t, spatial_shapes, loc, weights, n_heads)
    B, C, len_in = value_t.shape
    _, Q, _, L, P, _ = loc.shape
    if dout.shape != (B, C, Q) or dout.device != value_t.device:
        raise ValueError(f"d(out) must be {(B, C, Q)} on {value_t.device}, "
                         f"got {tuple(dout.shape)} on {dout.device}")
    if (C // n_heads) % 4 or C // n_heads > 128:
        raise ValueError(f"K8 takes head dims that are a multiple of 4 up to 128, "
                         f"got {C // n_heads}")
    value_t = value_t.contiguous()
    locf = loc.to(torch.float32).contiguous()
    wf = weights.to(torch.float32).contiguous()
    dout = dout.to(value_t.dtype).contiguous()
    # the kernel adds into this, (B, Len_in, C): zeroed each call, so untouched positions get 0
    scratch = torch.zeros((B, len_in, C), device=value_t.device, dtype=torch.float32)
    dvalue_t = torch.empty_like(value_t)
    dloc = torch.empty_like(locf)
    dw = torch.empty_like(wf)
    deform_attn_cm_bwd_kernel(value_t.data_ptr(), locf.data_ptr(), wf.data_ptr(),
                              dout.data_ptr(), scratch.data_ptr(), dvalue_t.data_ptr(),
                              dloc.data_ptr(), dw.data_ptr(), B, C, len_in, Q, n_heads, L, P,
                              _level_starts(spatial_shapes), _DTYPES[value_t.dtype])
    return dvalue_t, dloc.to(loc.dtype), dw.to(weights.dtype)


_ROUTE_KEYS = ("staged", "bulk_copy", "shared_bytes", "ctas_per_map", "threads", "registers",
               "local_bytes")


def cm_route(kernel: CudaKernel, value_t: torch.Tensor, n_queries: int, n_heads: int) -> dict:
    """The route K3 or K8 (`kernel`) takes on this CUDA value_t (B, C, Len_in)
    with `n_queries` queries, as its source chooses it: the (b, h) map staged
    in shared memory or gathered from device memory, copied by bulk copies or
    element by element, the shared bytes, CTAs a map and threads a CTA, and
    the registers and local (stack and spilled) bytes a thread of the kernel
    that runs."""
    if kernel.name not in ("K3", "K8"):
        raise ValueError(f"routes are reported for K3 and K8, not {kernel.name}")
    B, C, len_in = value_t.shape
    fn = getattr(load(kernel.source), kernel.symbol + "_route")
    fn.argtypes = [_P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * len(_ROUTE_KEYS))()
    err = fn(value_t.data_ptr(), B, C, len_in, n_queries, n_heads, _DTYPES[value_t.dtype], out)
    if err:
        raise RuntimeError(f"{kernel.symbol}_route failed: CUDA error {err}")
    route = dict(zip(_ROUTE_KEYS, out))
    route["route"] = ("device memory" if not route["staged"] else
                      "shared, bulk copy" if route["bulk_copy"] else "shared, element copy")
    return route


SEP_ROUTE_KEYS = ("channels_a_thread", "points_in_flight", "heads_a_cta", "queries_a_cta",
                   "threads", "shared_bytes", "ctas", "registers", "local_bytes")


def sep_route(kernel: CudaKernel, B: int, n_queries: int, n_heads: int, head_dim: int,
              n_levels: int, n_points: int, dtype: torch.dtype) -> dict:
    """The route K4 or K10 (`kernel`) takes for these sizes, as its source
    chooses it: the channels a thread gathers, the points whose corner loads
    are in flight together, the tile of heads and queries a CTA covers (its
    work order), threads a CTA, the point table's shared bytes, CTAs, and the
    registers and local (stack and spilled) bytes a thread of the kernel that
    runs."""
    if kernel.name not in ("K4", "K10"):
        raise ValueError(f"this route is reported for K4 and K10, not {kernel.name}")
    fn = getattr(load(kernel.source), kernel.symbol + "_route")
    fn.argtypes = [_I] * 7 + [ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * len(SEP_ROUTE_KEYS))()
    err = fn(B, n_queries, n_heads, head_dim, n_levels, n_points, _DTYPES[dtype], out)
    if err:
        raise RuntimeError(f"{kernel.symbol}_route failed: CUDA error {err}")
    route = dict(zip(SEP_ROUTE_KEYS, out))
    route["work_order"] = ("one (b, h) map a CTA" if route["heads_a_cta"] == 1 else
                           f"{route['heads_a_cta']} heads a CTA")
    return route


def ms_deform_attn_cm(value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                      loc: torch.Tensor, weights: torch.Tensor, n_heads: int) -> torch.Tensor:
    """value_t (B, C, Len_in) channel-major (padded positions already zeroed),
    loc (B, Q, H, L, P, 2) normalized (x, y), weights (B, Q, H, L, P)
    -> (B, C, Q) in value_t's dtype. Differentiable in value_t, loc and weights.
    K3 takes any head dim; when a gradient is wanted on a CUDA tensor and K8
    does not take the head dim, both run on `ms_deform_attn_cm_split`'s groups."""
    spatial_shapes = _int_shapes(spatial_shapes)
    D = value_t.shape[1] // n_heads
    multiple, largest = _CM_BWD_SPLIT
    if (needs_grad(value_t, loc, weights) and value_t.is_cuda
            and (D % multiple or D > largest)):
        return ms_deform_attn_cm_split(value_t, spatial_shapes, loc, weights, n_heads)
    return torch.ops.lwdetr.ms_deform_attn_cm(value_t, _flat_shapes(spatial_shapes), loc,
                                              weights, int(n_heads))


def ms_deform_attn_cm_split(value_t: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                            loc: torch.Tensor, weights: torch.Tensor,
                            n_heads: int) -> torch.Tensor:
    """`ms_deform_attn_cm` through K3 / K8 at a head dim K8 does not take: each
    head's channels zero-padded and split into `head_groups(D, 4, 128)`, each
    group sampled as a head with the head's points and weights, the output's
    padding sliced off. Zero channels sample zeros and add nothing to d(loc)
    or d(weights), which autograd sums over the groups. On CPU tensors the
    plain versions stand in for the kernels."""
    B, C, len_in = value_t.shape
    D = C // n_heads
    G, Dg = head_groups(D, *_CM_BWD_SPLIT)
    v = _groups_of(value_t.reshape(B, n_heads, D, len_in), 2, G, Dg)
    loc_g, w_g = _repeat_heads(loc, weights, G)
    out = ms_deform_attn_cm(v.reshape(B, n_heads * G * Dg, len_in), spatial_shapes, loc_g, w_g,
                            n_heads * G)
    Q = out.shape[-1]
    return out.reshape(B, n_heads, G * Dg, Q)[:, :, :D].reshape(B, C, Q)


def _rowmajor_panels(value: torch.Tensor, spatial_shapes):
    """Row-major (B, Len_in, H, D) as per-level panels (B, H, H_l, W_l * D)."""
    B, _, H, _ = value.shape
    panels, start = [], 0
    for h, w in spatial_shapes:
        panels.append(value[:, start:start + h * w].transpose(1, 2).reshape(B, H, h, -1))
        start += h * w
    return panels


def ms_deform_attn_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                         loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `ms_deform_attn` (counterpart of the JAX gather
    formulation of the same name): the corner gathers of
    `ms_deform_attn_sep_panels_plain` on the same values regrouped; on bf16
    values rounded as `_deform_kernel` does (`merged_corner_weights_plain`)."""
    if value.dtype == torch.bfloat16:
        B, _, H, D = value.shape
        out = _merged_sample_bf16(value.transpose(1, 2), spatial_shapes, loc, weights)
        return out.transpose(1, 2).reshape(B, -1, H * D)
    return ms_deform_attn_sep_panels_plain(_rowmajor_panels(value, spatial_shapes),
                                           spatial_shapes, loc, weights)


def ms_deform_attn_bwd_plain(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                             loc: torch.Tensor, weights: torch.Tensor, dout: torch.Tensor):
    """Plain PyTorch version of K10's backward: (d(value), d(loc), d(weights))
    of `ms_deform_attn` from d(out) (B, Q, H * D)."""
    B, _, H, D = value.shape
    dvals, dloc, dw = _sep_panels_bwd_formulas(
        _rowmajor_panels(value, spatial_shapes), spatial_shapes, loc, weights, dout)
    dvalue = torch.cat([dv.reshape(B, H, -1, D).transpose(1, 2) for dv in dvals], dim=1)
    return dvalue, dloc, dw


def _check_rowmajor_cuda(value, spatial_shapes, loc, weights, head_dims=_SEP_HEAD_DIMS):
    if value.dtype not in _DTYPES:
        raise TypeError(f"K10 takes float32 or bfloat16 values, got {value.dtype}")
    if value.dim() != 4 or value.shape[3] not in head_dims:
        raise ValueError(f"value must be (B, Len_in, H, D) with D in {head_dims}, "
                         f"got {tuple(value.shape)}")
    B, len_in, H, _ = value.shape
    L = len(spatial_shapes)
    if loc.dim() != 6 or loc.shape[0] != B or loc.shape[2:4] != (H, L) or loc.shape[-1] != 2:
        raise ValueError(f"loc must be ({B}, Q, {H}, {L}, P, 2), got {tuple(loc.shape)}")
    if weights.shape != loc.shape[:-1]:
        raise ValueError(f"weights must be {tuple(loc.shape[:-1])}, got {tuple(weights.shape)}")
    if not 1 <= L <= _MAX_LEVELS or sum(h * w for h, w in spatial_shapes) != len_in:
        raise ValueError(f"K10 takes 1..{_MAX_LEVELS} levels that add up to Len_in = {len_in}, "
                         f"got {spatial_shapes}")
    if not (value.device == loc.device == weights.device):
        raise ValueError("value, loc and weights must be on one device")


def ms_deform_attn_fwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                       loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """K10 forward launch on CUDA tensors (the plain version on the CPU), outside autograd."""
    if not value.is_cuda:
        return ms_deform_attn_plain(value, spatial_shapes, loc, weights)
    _check_rowmajor_cuda(value, spatial_shapes, loc, weights)
    B, len_in, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    value = value.contiguous()
    loc = loc.to(torch.float32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    _, level_hw = _level_args((), spatial_shapes)
    out = torch.empty((B, Q, H * D), device=value.device, dtype=value.dtype)
    deform_attn_rowmajor_kernel(value.data_ptr(), level_hw, loc.data_ptr(), weights.data_ptr(),
                                out.data_ptr(), B, len_in, Q, H, D, L, P, _DTYPES[value.dtype])
    return out


def ms_deform_attn_bwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                       loc: torch.Tensor, weights: torch.Tensor, dout: torch.Tensor):
    """K10 backward: (d(value), d(loc), d(weights)) of `ms_deform_attn` from
    d(out) (B, Q, H * D). d(value) is summed with f32 vector atomic adds, in
    no fixed order, and for bf16 values rounded once from the f32 sums."""
    if not value.is_cuda:
        return ms_deform_attn_bwd_plain(value, spatial_shapes, loc, weights, dout)
    _check_rowmajor_cuda(value, spatial_shapes, loc, weights, _SEP_BWD_HEAD_DIMS)
    B, len_in, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    if dout.shape != (B, Q, H * D) or dout.device != value.device:
        raise ValueError(f"d(out) must be {(B, Q, H * D)} on {value.device}, "
                         f"got {tuple(dout.shape)} on {dout.device}")
    value = value.contiguous()
    locf = loc.to(torch.float32).contiguous()
    wf = weights.to(torch.float32).contiguous()
    dout = dout.to(value.dtype).contiguous()
    # the kernel adds into this: zeroed each call, so untouched positions get 0
    dvalue = torch.zeros(value.shape, device=value.device, dtype=torch.float32)
    dloc = torch.empty_like(locf)
    dw = torch.empty_like(wf)
    _, level_hw = _level_args((), spatial_shapes)
    deform_attn_rowmajor_bwd_kernel(value.data_ptr(), dvalue.data_ptr(), level_hw,
                                    locf.data_ptr(), wf.data_ptr(), dout.data_ptr(),
                                    dloc.data_ptr(), dw.data_ptr(), B, len_in, Q, H, D, L, P,
                                    _DTYPES[value.dtype])
    return dvalue.to(value.dtype), dloc.to(loc.dtype), dw.to(weights.dtype)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """value (B, Len_in, H, D) row-major (padded positions already zeroed), loc
    (B, Q, H, L, P, 2) normalized (x, y), weights (B, Q, H, L, P) ->
    (B, Q, H * D) in value's dtype. Differentiable in value, loc and weights."""
    spatial_shapes = _int_shapes(spatial_shapes)
    if value.is_cuda and value.shape[-1] not in _SEP_HEAD_DIMS:
        return ms_deform_attn_split(value, spatial_shapes, loc, weights)
    return torch.ops.lwdetr.ms_deform_attn(value, _flat_shapes(spatial_shapes), loc, weights)


def ms_deform_attn_split(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                         loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """`ms_deform_attn` through K10 / K10b at a head dim they do not take:
    each head's channels zero-padded and split into `head_groups(D, 8, 64)`,
    sampled as heads of their own with the head's points and weights, the
    padding sliced off the output (see `ms_deform_attn_cm_split`). On CPU
    tensors the plain versions stand in for the kernels."""
    B, len_in, H, D = value.shape
    G, Dg = head_groups(D, *_SEP_SPLIT)
    v = _groups_of(value, 3, G, Dg).reshape(B, len_in, H * G, Dg)
    out = ms_deform_attn(v, spatial_shapes, *_repeat_heads(loc, weights, G))
    return _merge_groups_rowmajor(out, H, D)


def ms_deform_attn_sep_panels_plain(vals: Sequence[torch.Tensor],
                                    spatial_shapes: Sequence[Tuple[int, int]],
                                    loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: four corner gathers per level straight from the
    head-major panels, f32 sums, result in the panels' dtype. On bf16 panels it
    rounds as `_sep_kernel` does (`_sep_panels_bf16_plain`)."""
    if vals[0].dtype == torch.bfloat16:
        return _sep_panels_bf16_plain(vals, spatial_shapes, loc, weights)
    B, H = vals[0].shape[:2]
    Q, P = loc.shape[1], loc.shape[4]
    D = vals[0].shape[3] // spatial_shapes[0][1]
    ct = plain_dtype(vals[0])
    loc = loc.to(ct)
    weights = weights.to(ct)
    out = torch.zeros((B, H, Q, D), device=vals[0].device, dtype=ct)
    for lvl, ((Hl, Wl), panel) in enumerate(zip(spatial_shapes, vals)):
        v_l = panel.to(ct).reshape(B, H, Hl * Wl, D)
        px = loc[:, :, :, lvl, :, 0] * Wl - 0.5  # (B, Q, H, P)
        py = loc[:, :, :, lvl, :, 1] * Hl - 0.5
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = px - x0
        fy = py - y0
        x0 = x0.long()
        y0 = y0.long()
        aw = weights[:, :, :, lvl]  # (B, Q, H, P)
        for dy, dx, cw in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
            idx = yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)  # (B, Q, H, P)
            idx = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1).expand(-1, -1, -1, D)
            g = torch.gather(v_l, 2, idx).reshape(B, H, Q, P, D)
            coef = (cw * valid * aw).permute(0, 2, 1, 3)  # (B, H, Q, P)
            out = out + torch.einsum("bhqp,bhqpd->bhqd", coef, g)
    return out.permute(0, 2, 1, 3).reshape(B, Q, H * D).to(vals[0].dtype)


def _check_sep_cuda(vals, spatial_shapes, loc, weights, head_dims=_SEP_HEAD_DIMS):
    dtype = vals[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"K4 / K5 take float32 or bfloat16 panels, got {dtype}")
    if loc.dim() != 6 or loc.shape[-1] != 2:
        raise ValueError(f"loc must be (B, Q, H, L, P, 2), got {tuple(loc.shape)}")
    B, _, H, L, _, _ = loc.shape
    if weights.shape != loc.shape[:-1]:
        raise ValueError(f"weights must be {tuple(loc.shape[:-1])}, got {tuple(weights.shape)}")
    if not 1 <= L <= _MAX_LEVELS or len(vals) != L or len(spatial_shapes) != L:
        raise ValueError(f"K4 / K5 take 1..{_MAX_LEVELS} levels matching loc, got {len(vals)} panels "
                         f"and {len(spatial_shapes)} shapes for L = {L}")
    D, rem = divmod(vals[0].shape[-1], spatial_shapes[0][1])
    if rem or D not in head_dims:
        raise ValueError(f"K4 / K5 take head_dim in {head_dims}, got panel width "
                         f"{vals[0].shape[-1]} for W = {spatial_shapes[0][1]}")
    for panel, (h, w) in zip(vals, spatial_shapes):
        if panel.shape != (B, H, h, w * D) or panel.dtype != dtype:
            raise ValueError(f"panel must be {(B, H, h, w * D)} in {dtype}, "
                             f"got {tuple(panel.shape)} in {panel.dtype}")
    if any(t.device != loc.device for t in (*vals, weights)):
        raise ValueError("panels, loc and weights must be on one device")


def ms_deform_attn_sep_panels_bwd_plain(vals: Sequence[torch.Tensor],
                                        spatial_shapes: Sequence[Tuple[int, int]],
                                        loc: torch.Tensor, weights: torch.Tensor,
                                        dout: torch.Tensor):
    """Plain PyTorch version of K5: the gradients of `ms_deform_attn_sep_panels`
    from d(out) (B, Q, H * D), by the explicit formulas, in f32. With g the
    head's slice of d(out) and v00, v01, v10, v11 a point's corner values (0
    outside the map): d(weights) = <g, bilinear value>, d(loc_x) = W_l w
    <g, (1-fy)(v01-v00) + fy (v11-v10)>, d(loc_y) = H_l w <g, (1-fx)(v10-v00)
    + fx (v11-v01)>, and d(panel) is the scatter-add of w x corner weight x g.
    d(loc) differences the corner values first and takes one dot product:
    neighbouring values are close and their difference is exact (Sterbenz),
    where the difference of two dot products (the JAX package's VJP of
    `_prep_separable`) cancels and keeps the rounding of each, of order
    eps |<g, v00>|. So this is closer to exact than `jax.grad`, by that much.
    Returns ([d(panel_l)] in the panels' dtype, d(loc), d(weights)). On bf16
    panels it computes as `_sep_bwd_kernel` and the VJP of `_prep_separable`
    do (`_sep_panels_bwd_bf16_plain`)."""
    if vals[0].dtype == torch.bfloat16:
        return _sep_panels_bwd_bf16_plain(vals, spatial_shapes, loc, weights, dout)
    return _sep_panels_bwd_formulas(vals, spatial_shapes, loc, weights, dout)


def _sep_panels_bwd_formulas(vals, spatial_shapes, loc, weights, dout):
    """The explicit formulas of `ms_deform_attn_sep_panels_bwd_plain` in f32
    (f64 on f64 inputs), whatever the panels' dtype; d(panel) rounded once to
    it. The row-major backward (K10b) takes these in bf16 too, the
    channel-major one (K8) for d(loc) and d(weights)."""
    B, H = vals[0].shape[:2]
    Q, P = loc.shape[1], loc.shape[4]
    D = vals[0].shape[3] // spatial_shapes[0][1]
    ct = plain_dtype(vals[0])
    locf = loc.to(ct)
    wf = weights.to(ct)
    g = dout.to(ct).reshape(B, Q, H, D).permute(0, 2, 1, 3)  # (B, H, Q, D)
    dloc = torch.zeros_like(locf)
    dw = torch.zeros_like(wf)
    dvals: List[torch.Tensor] = []
    for lvl, ((Hl, Wl), panel) in enumerate(zip(spatial_shapes, vals)):
        v_l = panel.to(ct).reshape(B, H, Hl * Wl, D)
        px = locf[:, :, :, lvl, :, 0] * Wl - 0.5  # (B, Q, H, P)
        py = locf[:, :, :, lvl, :, 1] * Hl - 0.5
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = px - x0
        fy = py - y0
        x0 = x0.long()
        y0 = y0.long()
        aw = wf[:, :, :, lvl]  # (B, Q, H, P)
        dv = torch.zeros_like(v_l)
        corners = []
        for dy, dx, cw in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            xi = x0 + dx
            yi = y0 + dy
            valid = ((xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)).permute(0, 2, 1, 3)
            idx = yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)  # (B, Q, H, P)
            idx = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1).expand(-1, -1, -1, D)
            corner = torch.gather(v_l, 2, idx).reshape(B, H, Q, P, D)
            corners.append(corner * valid[..., None])  # (B, H, Q, P, D), 0 outside
            coef = cw.permute(0, 2, 1, 3) * valid * aw.permute(0, 2, 1, 3)  # (B, H, Q, P)
            add = coef[..., None] * g[:, :, :, None, :]  # (B, H, Q, P, D)
            dv.scatter_add_(2, idx, add.reshape(B, H, Q * P, D))
        v00, v01, v10, v11 = corners
        fxc, fyc = (t.permute(0, 2, 1, 3)[..., None] for t in (fx, fy))  # (B, H, Q, P, 1)

        def dot(t):  # <g, t> over the head's channels, as (B, Q, H, P)
            return torch.einsum("bhqd,bhqpd->bhqp", g, t).permute(0, 2, 1, 3)

        dw[:, :, :, lvl] = dot((1 - fyc) * ((1 - fxc) * v00 + fxc * v01)
                               + fyc * ((1 - fxc) * v10 + fxc * v11))
        dloc[:, :, :, lvl, :, 0] = Wl * aw * dot((1 - fyc) * (v01 - v00) + fyc * (v11 - v10))
        dloc[:, :, :, lvl, :, 1] = Hl * aw * dot((1 - fxc) * (v10 - v00) + fxc * (v11 - v01))
        dvals.append(dv.reshape(panel.shape).to(panel.dtype))
    return dvals, dloc.to(loc.dtype), dw.to(weights.dtype)


def _level_args(vals, spatial_shapes):
    """The host arrays a panel kernel takes: a pointer and (h, w) per level
    (the row-major kernels take the second alone)."""
    panels = (ctypes.c_void_p * len(vals))(*(v.data_ptr() for v in vals))
    level_hw = (ctypes.c_int * (2 * len(spatial_shapes)))(*(x for hw in spatial_shapes
                                                            for x in hw))
    return panels, level_hw


def ms_deform_attn_sep_panels_bwd(vals: Sequence[torch.Tensor],
                                  spatial_shapes: Sequence[Tuple[int, int]],
                                  loc: torch.Tensor, weights: torch.Tensor, dout: torch.Tensor):
    """K5: ([d(panel_l)], d(loc), d(weights)) of `ms_deform_attn_sep_panels`
    from d(out) (B, Q, H * D). d(panel) is summed with f32 vector atomic adds,
    in no fixed order, and for bf16 panels rounded once from the f32 sums."""
    spatial_shapes = _int_shapes(spatial_shapes)
    vals = list(vals)
    if not vals[0].is_cuda:
        return ms_deform_attn_sep_panels_bwd_plain(vals, spatial_shapes, loc, weights, dout)
    _check_sep_cuda(vals, spatial_shapes, loc, weights, _SEP_BWD_HEAD_DIMS)
    B, Q, H, L, P, _ = loc.shape
    D = vals[0].shape[-1] // spatial_shapes[0][1]
    if dout.shape != (B, Q, H * D) or dout.device != loc.device:
        raise ValueError(f"d(out) must be {(B, Q, H * D)} on {loc.device}, "
                         f"got {tuple(dout.shape)} on {dout.device}")
    vals = [v.contiguous() for v in vals]
    locf = loc.to(torch.float32).contiguous()
    wf = weights.to(torch.float32).contiguous()
    dout = dout.to(vals[0].dtype).contiguous()
    # the kernel adds into these: zeroed each call, so untouched positions get 0
    dvals = [torch.zeros(v.shape, device=v.device, dtype=torch.float32) for v in vals]
    dloc = torch.empty_like(locf)
    dw = torch.empty_like(wf)
    panels, level_hw = _level_args(vals, spatial_shapes)
    dpanels, _ = _level_args(dvals, spatial_shapes)
    deform_attn_sep_bwd_kernel(panels, dpanels, level_hw, locf.data_ptr(), wf.data_ptr(),
                               dout.data_ptr(), dloc.data_ptr(), dw.data_ptr(), B, Q, H, D, L, P,
                               _DTYPES[vals[0].dtype])
    return ([dv.to(v.dtype) for dv, v in zip(dvals, vals)], dloc.to(loc.dtype),
            dw.to(weights.dtype))


def ms_deform_attn_sep_panels_fwd(vals: Sequence[torch.Tensor],
                                  spatial_shapes: Sequence[Tuple[int, int]],
                                  loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """K4 launch on CUDA tensors (the plain version on the CPU), outside autograd."""
    if not vals[0].is_cuda:
        return ms_deform_attn_sep_panels_plain(vals, spatial_shapes, loc, weights)
    _check_sep_cuda(vals, spatial_shapes, loc, weights)
    B, Q, H, L, P, _ = loc.shape
    D = vals[0].shape[-1] // spatial_shapes[0][1]
    vals = [v.contiguous() for v in vals]
    loc = loc.to(torch.float32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    panels, level_hw = _level_args(vals, spatial_shapes)
    out = torch.empty((B, Q, H * D), device=loc.device, dtype=vals[0].dtype)
    deform_attn_sep_kernel(panels, level_hw, loc.data_ptr(), weights.data_ptr(),
                           out.data_ptr(), B, Q, H, D, L, P, _DTYPES[vals[0].dtype])
    return out


def ms_deform_attn_sep_panels(vals: Sequence[torch.Tensor],
                              spatial_shapes: Sequence[Tuple[int, int]],
                              loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """vals[l] (B, H, H_l, W_l * D) head-major value panels (padded positions
    already zeroed), loc (B, Q, H, L, P, 2) normalized (x, y), weights
    (B, Q, H, L, P) -> (B, Q, H * D) row-major in the panels' dtype.
    Differentiable in the panels, loc and weights."""
    spatial_shapes = _int_shapes(spatial_shapes)
    vals = list(vals)
    if vals[0].is_cuda and vals[0].shape[-1] // spatial_shapes[0][1] not in _SEP_HEAD_DIMS:
        return ms_deform_attn_sep_panels_split(vals, spatial_shapes, loc, weights)
    return torch.ops.lwdetr.ms_deform_attn_sep_panels(vals, _flat_shapes(spatial_shapes), loc,
                                                      weights)


def ms_deform_attn_sep_panels_split(vals: Sequence[torch.Tensor],
                                    spatial_shapes: Sequence[Tuple[int, int]],
                                    loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """`ms_deform_attn_sep_panels` through K4 / K5 at a head dim they do not
    take: each head's channels zero-padded and split into `head_groups(D, 8,
    64)`, each group's panel sampled as a head of its own with the head's
    points and weights, the padding sliced off the output (see
    `ms_deform_attn_cm_split`). On CPU tensors the plain versions stand in for
    the kernels."""
    spatial_shapes = _int_shapes(spatial_shapes)
    B, H = vals[0].shape[:2]
    D = vals[0].shape[-1] // spatial_shapes[0][1]
    G, Dg = head_groups(D, *_SEP_SPLIT)
    panels = []
    for panel, (h, w) in zip(vals, spatial_shapes):
        v = _groups_of(panel.reshape(B, H, h, w, D), 4, G, Dg)  # (B, H, h, w, G, Dg)
        panels.append(v.permute(0, 1, 4, 2, 3, 5).reshape(B, H * G, h, w * Dg))
    out = ms_deform_attn_sep_panels(panels, spatial_shapes, *_repeat_heads(loc, weights, G))
    return _merge_groups_rowmajor(out, H, D)


# ---------------------------------------------------------------------------
# operators: the forward kernels K3, K4 and K10 as operators of the `lwdetr`
# namespace (torch.library), so that `torch.export` traces each as one opaque
# node (its fake version gives the output's shape and dtype) and an exported
# graph runs the kernel. Eager calls take the same operators. `spatial_shapes` goes in as
# one flat list (h0, w0, h1, w1, ...). Each operator's implementation calls
# the module's `*_fwd` function, looked up when it runs: on CUDA tensors it
# launches the kernel or raises, on the CPU it runs the plain version. Each
# backward calls the module's `*_bwd` function likewise (K8, K5, K10b).
# ---------------------------------------------------------------------------


def _flat_shapes(spatial_shapes) -> List[int]:
    return [int(x) for hw in spatial_shapes for x in hw]


def _pairs(flat: Sequence[int]) -> List[Tuple[int, int]]:
    return list(zip(flat[0::2], flat[1::2]))


@torch.library.custom_op("lwdetr::ms_deform_attn_cm", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _ms_deform_attn_cm_op(value_t: torch.Tensor, spatial_shapes: List[int], loc: torch.Tensor,
                          weights: torch.Tensor, n_heads: int) -> torch.Tensor:
    return ms_deform_attn_cm_fwd(value_t, _pairs(spatial_shapes), loc, weights, n_heads)


@torch.library.custom_op("lwdetr::ms_deform_attn_sep_panels", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _ms_deform_attn_sep_panels_op(vals: List[torch.Tensor], spatial_shapes: List[int],
                                  loc: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return ms_deform_attn_sep_panels_fwd(vals, _pairs(spatial_shapes), loc, weights)


@torch.library.custom_op("lwdetr::ms_deform_attn", mutates_args=(), device_types=("cpu", "cuda"))
def _ms_deform_attn_op(value: torch.Tensor, spatial_shapes: List[int], loc: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    return ms_deform_attn_fwd(value, _pairs(spatial_shapes), loc, weights)


@_ms_deform_attn_cm_op.register_fake
def _(value_t, spatial_shapes, loc, weights, n_heads):
    return value_t.new_empty((value_t.shape[0], value_t.shape[1], loc.shape[1]))


@_ms_deform_attn_sep_panels_op.register_fake
def _(vals, spatial_shapes, loc, weights):
    B, H, _, WD = vals[0].shape
    return vals[0].new_empty((B, loc.shape[1], H * (WD // spatial_shapes[1])))


@_ms_deform_attn_op.register_fake
def _(value, spatial_shapes, loc, weights):
    B, _, H, D = value.shape
    return value.new_empty((B, loc.shape[1], H * D))


def _save_sampler(ctx, inputs, output):
    """The tensors (a panel list flattened after loc and weights), and the rest."""
    value, shapes, loc, weights, *rest = inputs
    ctx.spatial_shapes, ctx.rest = _pairs(shapes), rest
    ctx.save_for_backward(loc, weights, *(value if isinstance(value, list) else [value]))


def _deform_attn_cm_backward(ctx, dout):
    """K8."""
    loc, weights, value_t = ctx.saved_tensors
    dvalue_t, dloc, dw = ms_deform_attn_cm_bwd(value_t, ctx.spatial_shapes, loc, weights, dout,
                                               *ctx.rest)
    return dvalue_t, None, dloc, dw, None


def _deform_attn_sep_panels_backward(ctx, dout):
    """K5."""
    loc, weights, *vals = ctx.saved_tensors
    dvals, dloc, dw = ms_deform_attn_sep_panels_bwd(vals, ctx.spatial_shapes, loc, weights, dout)
    return list(dvals), None, dloc, dw


def _deform_attn_backward(ctx, dout):
    """K10's backward."""
    loc, weights, value = ctx.saved_tensors
    dvalue, dloc, dw = ms_deform_attn_bwd(value, ctx.spatial_shapes, loc, weights, dout)
    return dvalue, None, dloc, dw


_ms_deform_attn_cm_op.register_autograd(_deform_attn_cm_backward, setup_context=_save_sampler)
_ms_deform_attn_sep_panels_op.register_autograd(_deform_attn_sep_panels_backward,
                                                setup_context=_save_sampler)
_ms_deform_attn_op.register_autograd(_deform_attn_backward, setup_context=_save_sampler)

# ---------------------------------------------------------------------------
# bf16: where the JAX kernels round
#
# The JAX package's bf16 samplers round in more places than one rounding of
# an f32 sum, and the port's bf16 plain versions and kernels round where they
# do. The f32 paths are untouched by any of this.
# * `_sep_kernel` (K4): the y- and x-weights are packed in bf16, the attention
#   weight folded into the x-weights first (`_prep_separable`); a point's row
#   gather is summed in f32, times its x-weight (rounded); the points' entries
#   that share a column are summed in f32 and that column sum is rounded to
#   bf16 before the regroup sums the columns in f32 (`msum.astype(dt)`).
# * `_deform_kernel` (K10) and `_deform_cm_kernel` (K3): a corner's weight
#   (1-fy)(1-fx) x aw in f32; the weights of all the corners of one (q, h)
#   that land on one position are summed in f32 and the sum rounded to bf16
#   before its product with the value.
# * `_sep_bwd_kernel` (K5): see `_sep_panels_bwd_bf16_plain`.
# * `_dvalue_cm_kernel` (K8): d(value) from the merged weights of the forward,
#   rounded alike (`ms_deform_attn_cm_bwd_plain`). K10b's `_dvalue_kernel`
#   keeps them in f32, as the port does.
# ---------------------------------------------------------------------------


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even), as f32."""
    return t.to(torch.bfloat16).float()


def _grid(loc_l: torch.Tensor, Hl: int, Wl: int):
    """A level's points (B, Q, H, P, 2) -> integer upper-left corners and
    fractions, x W - 0.5 rounded as PyTorch rounds it."""
    px = loc_l[..., 0] * Wl - 0.5
    py = loc_l[..., 1] * Hl - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    return x0.long(), y0.long(), px - x0, py - y0


def _ordered_sum(terms: torch.Tensor, keys: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum `terms` along `dim` one after another in ascending `keys` order,
    in f32 (the order the JAX kernels' matmuls take over their positions)."""
    order = keys.argsort(dim=dim, stable=True)
    shape = list(order.shape) + [1] * (terms.dim() - order.dim())
    terms = torch.gather(terms, dim, order.reshape(shape).expand_as(terms))
    acc = torch.zeros_like(terms.select(dim, 0))
    for i in range(terms.shape[dim]):
        acc = acc + terms.select(dim, i)
    return acc


def _group_sums(keys: torch.Tensor, terms: torch.Tensor):
    """For entries along the last dim of `keys` (terms: the same leading dims,
    maybe a trailing channel dim): the f32 sum of the terms of the entries
    that share an entry's key, in entry order, and whether the entry is the
    first of its key (the one that carries the sum)."""
    n = keys.shape[-1]
    same = keys[..., :, None] == keys[..., None, :]  # (..., n, n)
    earlier = torch.ones(n, n, dtype=torch.bool, device=keys.device).tril(-1)
    first = ~(same & earlier).any(dim=-1)
    wide = terms.dim() > keys.dim()
    sums = torch.zeros_like(terms)
    for j in range(n):  # entry order: the JAX kernels' sums run in it
        hit = same[..., j]
        t = terms[..., j:j + 1, :] if wide else terms[..., j:j + 1]
        sums = sums + torch.where(hit[..., None] if wide else hit, t, torch.zeros_like(t))
    return sums, first


def merged_corner_weights_plain(spatial_shapes, loc: torch.Tensor, weights: torch.Tensor):
    """The corners of every (b, q, h) over all levels as `_deform_kernel` /
    `_deform_cm_kernel` form them: (position into the level-concatenated map,
    -1 outside; its f32 weight, the weights of the corners that land on one
    position summed in entry order and rounded to bf16, 0 on all but the first
    of them), each (B, Q, H, 4 L P), entries ordered (level, corner, point)."""
    idx_parts, w_parts = [], []
    start = 0
    aw_all = weights.float()
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        x0, y0, fx, fy = _grid(loc[:, :, :, lvl].float(), Hl, Wl)
        aw = aw_all[:, :, :, lvl]
        for dy, dx, cw in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                           (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
            idx = start + yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)
            idx_parts.append(torch.where(valid, idx, torch.full_like(idx, -1)))
            w_parts.append(cw * valid.float() * aw)
        start += Hl * Wl
    idx = torch.cat(idx_parts, dim=-1)  # (B, Q, H, L * 4 * P), (level, corner, point)
    w = torch.cat(w_parts, dim=-1)
    sums, first = _group_sums(idx, w)
    return idx, torch.where(first & (idx >= 0), _bf16(sums), torch.zeros_like(sums))


def _merged_sample_bf16(value_hm: torch.Tensor, spatial_shapes, loc: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """K10 / K3 on bf16 values (B, H, Len_in, D) -> (B, H, Q, D) bf16: the
    rounded merged weights times the values, summed in f32 in ascending
    position order, rounded once."""
    B, H, _, D = value_hm.shape
    Q = loc.shape[1]
    idx, w = merged_corner_weights_plain(spatial_shapes, loc, weights)  # (B, Q, H, J)
    idx = idx.permute(0, 2, 1, 3)  # (B, H, Q, J)
    w = w.permute(0, 2, 1, 3)
    J = idx.shape[-1]
    g = torch.gather(value_hm.float(), 2, idx.clamp(min=0).reshape(B, H, Q * J, 1)
                     .expand(-1, -1, -1, D)).reshape(B, H, Q, J, D)
    terms = w[..., None] * g
    keys = torch.where(idx >= 0, idx, torch.full_like(idx, torch.iinfo(torch.int64).max))
    return _ordered_sum(terms, keys, 3).to(torch.bfloat16)


def _sep_level_bf16(loc_l, aw, Hl: int, Wl: int):
    """One level's separable packing of `_prep_separable` in bf16, (B, Q, H, P)
    each: the clamped rows and columns, the bf16 y-weights and x-weights (the
    attention weight folded into the x-weights before the rounding, as f32),
    and the f32 parts the VJP reads (fractions, the in-map flags, the
    x-weights before the attention weight)."""
    x0, y0, fx, fy = _grid(loc_l, Hl, Wl)
    y0ok = ((y0 >= 0) & (y0 < Hl)).float()
    y1ok = ((y0 + 1 >= 0) & (y0 + 1 < Hl)).float()
    x0ok = ((x0 >= 0) & (x0 < Wl)).float()
    x1ok = ((x0 + 1 >= 0) & (x0 + 1 < Wl)).float()
    xwu0, xwu1 = (1.0 - fx) * x0ok, fx * x1ok
    return dict(ya=y0.clamp(0, Hl - 1), yb=(y0 + 1).clamp(0, Hl - 1),
                xa=x0.clamp(0, Wl - 1), xb=(x0 + 1).clamp(0, Wl - 1),
                wy0=_bf16((1.0 - fy) * y0ok), wy1=_bf16(fy * y1ok),
                wx0=_bf16(xwu0 * aw), wx1=_bf16(xwu1 * aw),
                xwu0=xwu0, xwu1=xwu1, y0ok=y0ok, y1ok=y1ok, x0ok=x0ok, x1ok=x1ok)


def _gather_hm(v_l: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """v_l (B, H, N, D) at positions pos (B, Q, H, P) -> (B, H, Q, P, D)."""
    B, H, _, D = v_l.shape
    Q, P = pos.shape[1], pos.shape[3]
    idx = pos.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1).expand(-1, -1, -1, D)
    return torch.gather(v_l, 2, idx).reshape(B, H, Q, P, D)


def _hm(t: torch.Tensor) -> torch.Tensor:
    """(B, Q, H, P) -> (B, H, Q, P, 1), to weigh (B, H, Q, P, D) corners."""
    return t.permute(0, 2, 1, 3)[..., None]


def _sep_panels_bf16_plain(vals, spatial_shapes, loc, weights) -> torch.Tensor:
    """K4 on bf16 panels, rounded as `_sep_kernel` rounds (see above)."""
    B, H = vals[0].shape[:2]
    Q, P = loc.shape[1], loc.shape[4]
    D = vals[0].shape[3] // spatial_shapes[0][1]
    acc = torch.zeros((B, H, Q, D), device=loc.device, dtype=torch.float32)
    for lvl, ((Hl, Wl), panel) in enumerate(zip(spatial_shapes, vals)):
        v_l = panel.float().reshape(B, H, Hl * Wl, D)
        k = _sep_level_bf16(loc[:, :, :, lvl].float(), weights[:, :, :, lvl].float(), Hl, Wl)
        # entries (point, column): e = 2 p + c, as the kernel's point order
        cols, terms = [], []
        for xc, wx in ((k["xa"], k["wx0"]), (k["xb"], k["wx1"])):
            g = (_hm(k["wy0"]) * _gather_hm(v_l, k["ya"] * Wl + xc)
                 + _hm(k["wy1"]) * _gather_hm(v_l, k["yb"] * Wl + xc))  # f32, one rounding
            terms.append(_hm(wx) * g)  # (B, H, Q, P, D)
            cols.append(xc.permute(0, 2, 1, 3))
        col = torch.stack(cols, dim=-1).reshape(B, H, Q, 2 * P)
        m = torch.stack(terms, dim=4).reshape(B, H, Q, 2 * P, D)
        sums, first = _group_sums(col, m)
        r = torch.where(first[..., None], _bf16(sums), torch.zeros_like(sums))
        acc = acc + _ordered_sum(r, col, 3)  # the regroup: columns ascending, in f32
    return acc.permute(0, 2, 1, 3).reshape(B, Q, H * D).to(torch.bfloat16)


def _sep_panels_bwd_bf16_plain(vals, spatial_shapes, loc, weights, dout, with_bound=False):
    """K5 on bf16 panels, as `_sep_bwd_kernel` and the VJP of `_prep_separable`
    compute it. With g the head's bf16 d(out), per point and column c of its
    two (clamped) columns, and rows r:
      g_c      = wy0 v[ya, x_c] + wy1 v[yb, x_c]            (f32)
      d(xw_c)  = bf16(sum_d g_c g)                          (each product rounded, then summed)
      dg_c     = bf16(xw_c g)
      d(yw_r)  = bf16(sum_{c, d} dg_c v[y_r, x_c])
      d(value)[y_r, x_c] += yw_r dg_c                        (f32, rounded once at the end)
    then in f32: d(aw) = sum_c d(xw_c) xwu_c, d(loc_x) = W (aw d(xw_1) x1ok -
    aw d(xw_0) x0ok), d(loc_y) = H (d(yw_1) y1ok - d(yw_0) y0ok). With
    `with_bound`, also the bounds of `sep_panels_bwd_bf16_bound`."""
    B, H = vals[0].shape[:2]
    Q, P = loc.shape[1], loc.shape[4]
    D = vals[0].shape[3] // spatial_shapes[0][1]
    g = dout.to(torch.bfloat16).float().reshape(B, Q, H, D).permute(0, 2, 1, 3)[:, :, :, None]
    dloc = torch.zeros(loc.shape, device=loc.device, dtype=torch.float32)
    dw = torch.zeros(weights.shape, device=loc.device, dtype=torch.float32)
    bloc, bw = torch.zeros_like(dloc), torch.zeros_like(dw)
    dvals = []
    for lvl, ((Hl, Wl), panel) in enumerate(zip(spatial_shapes, vals)):
        v_l = panel.float().reshape(B, H, Hl * Wl, D)
        aw = weights[:, :, :, lvl].float()
        k = _sep_level_bf16(loc[:, :, :, lvl].float(), aw, Hl, Wl)
        dv = torch.zeros_like(v_l)
        rows = ((k["ya"], k["wy0"]), (k["yb"], k["wy1"]))
        dxw, dya = [], [0.0, 0.0]
        for xc, wx in ((k["xa"], k["wx0"]), (k["xb"], k["wx1"])):
            va = _gather_hm(v_l, k["ya"] * Wl + xc)
            vb = _gather_hm(v_l, k["yb"] * Wl + xc)
            gc = _hm(k["wy0"]) * va + _hm(k["wy1"]) * vb  # (B, H, Q, P, D)
            dxw.append(_bf16((gc * g).sum(-1)).permute(0, 2, 1, 3))  # (B, Q, H, P)
            dg = _bf16(_hm(wx) * g)
            for r, ((yr, wy), vr) in enumerate(zip(rows, (va, vb))):
                dya[r] = dya[r] + (dg * vr).sum(-1)
                pos = (yr * Wl + xc).permute(0, 2, 1, 3).reshape(B, H, Q * P, 1)
                dv.scatter_add_(2, pos.expand(-1, -1, -1, D),
                                (_hm(wy) * dg).reshape(B, H, Q * P, D))
        dyw = [_bf16(t).permute(0, 2, 1, 3) for t in dya]
        dw[:, :, :, lvl] = dxw[0] * k["xwu0"] + dxw[1] * k["xwu1"]
        dloc[:, :, :, lvl, :, 0] = ((dxw[1] * aw) * k["x1ok"] - (dxw[0] * aw) * k["x0ok"]) * Wl
        dloc[:, :, :, lvl, :, 1] = (dyw[1] * k["y1ok"] - dyw[0] * k["y0ok"]) * Hl
        if with_bound:
            ux, uy = [_bf16_ulp(t) for t in dxw], [_bf16_ulp(t) for t in dyw]
            bw[:, :, :, lvl] = ux[0] * k["xwu0"] + ux[1] * k["xwu1"]
            bloc[:, :, :, lvl, :, 0] = Wl * aw * (ux[0] * k["x0ok"] + ux[1] * k["x1ok"])
            bloc[:, :, :, lvl, :, 1] = Hl * (uy[0] * k["y0ok"] + uy[1] * k["y1ok"])
        dvals.append(dv.reshape(panel.shape).to(panel.dtype))
    out = (dvals, dloc.to(loc.dtype), dw.to(weights.dtype))
    return out + (bloc, bw) if with_bound else out


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |t| (7 fraction bits), at least 2^-133."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126))) - 7)


def sep_panels_bwd_bf16_bound(vals, spatial_shapes, loc, weights, dout):
    """How far K5's bf16 d(loc) and d(weights) may lie from the plain
    version's: each comes from four bf16 weight gradients (d(xw_c), d(yw_r)),
    sums of products that the kernel adds in another f32 order, so each may
    round to the neighbouring bf16 number; the bound is what one ulp of each
    moves: (W aw (ulp(d(xw_0)) + ulp(d(xw_1))), H (ulp(d(yw_0)) + ulp(d(yw_1))))
    for d(loc), ulp(d(xw_0)) (1-fx) + ulp(d(xw_1)) fx for d(weights), with the
    flags of the columns and rows in the map. Returns (d(loc) bound,
    d(weights) bound), f32."""
    return _sep_panels_bwd_bf16_plain(list(vals), _int_shapes(spatial_shapes), loc, weights,
                                      dout, with_bound=True)[3:]
