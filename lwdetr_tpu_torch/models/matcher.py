"""Hungarian matching of predictions to targets, on the device.

Counterpart of `lwdetr_tpu/models/matcher.py`: the same cost (focal class
cost + L1 + GIoU), built for every (output set, image, group) in one tensor,
and the same assignment, the JAX package's `solve_assignment`: Jonker-Volgenant
shortest augmenting paths with dual potentials, augmenting only the first
`sum(valid)` target rows of each image (the loader packs the valid targets
first), the Dijkstra argmin taking the lowest column among equal minima and a
NaN before any number (`jnp.argmin`), and the JAX solver's finite "infinity"
1e15, on which its loop ends for any input, NaN costs included.

On CUDA tensors the assignment is M1 (`csrc/matcher.cu`), one launch for all
problems, which reads the valid counts on the device: no host
synchronisation. On CPU tensors it is `solve_assignment_plain`, the JAX loop
written with torch ops over all problems in lockstep, as `vmap` runs it, with
the same operations in the same order; M1 is held against it on the card,
and it against `jax` `solve_assignment` in the tests (the same columns).
Both cap a row's Dijkstra at 2 (Q + 1) + 1 steps and a backtrack at
n_rows + 1 steps, a guard the JAX loop never reaches. Everything here runs
under `torch.no_grad()`.
"""
from __future__ import annotations

import ctypes

import torch

from lwdetr_tpu_torch.ops import box_ops
from lwdetr_tpu_torch.ops._build import CudaKernel, load
from lwdetr_tpu_torch.utils import trace

INF = 1e15  # the JAX solver's `_INF` (lwdetr_tpu/models/matcher.py:26): finite

_P = ctypes.c_void_p
_I = ctypes.c_int

# M1 replaces lwdetr_tpu/models/matcher.py:29 solve_assignment (device code, not Pallas)
assignment_kernel = CudaKernel("M1", "matcher.cu", "lw_assignment",
                               [_P, _P, _P, _I, _I, _I, _I, _I])


def match_cost_matrix(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                      tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                      tgt_valid: torch.Tensor, cost_class: float = 2.0, cost_bbox: float = 5.0,
                      cost_giou: float = 2.0, focal_alpha: float = 0.25) -> torch.Tensor:
    """pred_logits (..., B, Q, K), pred_boxes (..., B, Q, 4) cxcywh; tgt_labels
    (B, T) int, tgt_boxes (B, T, 4) cxcywh (a valid dummy box where padded),
    tgt_valid (B, T) bool -> cost (..., B, T, Q) f32; padded rows are 0."""
    gamma = 2.0
    prob = pred_logits.float().sigmoid()  # (..., B, Q, K)
    idx = tgt_labels.long()[:, None, :].expand(*prob.shape[:-1], tgt_labels.shape[1])
    p_t = torch.gather(prob, -1, idx)  # (..., B, Q, T)
    neg = (1 - focal_alpha) * (p_t ** gamma) * (-torch.log(1 - p_t + 1e-8))
    pos = focal_alpha * ((1 - p_t) ** gamma) * (-torch.log(p_t + 1e-8))
    pred_boxes = pred_boxes.float()
    tgt_boxes = tgt_boxes.float()
    c_bbox = (pred_boxes[..., :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    giou = box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(pred_boxes),
                                       box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    cost = cost_bbox * c_bbox + cost_class * (pos - neg) - cost_giou * giou
    cost = cost.masked_fill(~tgt_valid[:, None, :], 0.0)
    return cost.transpose(-1, -2)


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """`jnp.argmin` over the last dim: the first NaN if there is one, else the
    first of the equal minima. Formed from integer minima, so no device's
    tie rule for floating argmin enters."""
    n = x.shape[-1]
    cols = torch.arange(n, device=x.device)
    nan = torch.isnan(x)
    lowest = torch.where(nan, torch.inf, x).amin(-1, keepdim=True)
    first_min = torch.where(x == lowest, cols, n).amin(-1)
    first_nan = torch.where(nan, cols, n).amin(-1)
    return torch.where(nan.any(-1), first_nan, first_min)


@torch.no_grad()
def solve_assignment_plain(cost: torch.Tensor, n_rows: torch.Tensor) -> torch.Tensor:
    """Plain version of M1: cost (P, T, Q), n_rows (P,) -> (P, T) int64, the
    column of each of the first n_rows rows of each problem (at most Q of
    them: a row past the Q-th has no column left); the other rows hold 0.

    The JAX loop (lwdetr_tpu/models/matcher.py:29-137) over all P problems
    at once, a problem taking part in a step while its own loop runs: the
    1-indexed (T + 1, Q + 1) cost with a zero row and column 0, `cur = C[i0]
    - u[i0] - v` as two f32 subtractions, both contractions as the JAX code
    forms them (a one-hot product over every row, so a non-finite entry of
    another row makes the column NaN, as 0 x inf does there; u[i0] as a
    one-hot sum), minv / way / used updates, `jnp.argmin` ties and NaNs."""
    P, T, Q = cost.shape
    dev = cost.device
    C = cost.new_zeros((P, T + 1, Q + 1), dtype=torch.float32)
    C[:, 1:, 1:] = cost.float()
    bad = (~torch.isfinite(C)).sum(1)  # (P, Q + 1) non-finite entries of each column
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    u = torch.zeros((P, T + 1), dtype=torch.float32, device=dev)
    v = torch.zeros((P, Q + 1), dtype=torch.float32, device=dev)
    p = torch.zeros((P, Q + 1), dtype=torch.long, device=dev)
    ar = torch.arange(P, device=dev)
    cols = torch.arange(Q + 1, device=dev)
    rows = torch.arange(T + 1, device=dev)
    n = n_rows.to(dev).long().clamp(0, min(T, Q))
    for i in range(1, int(n.max()) + 1 if P else 1):
        act = n >= i  # the problems that augment row i
        p[:, 0] = torch.where(act, i, p[:, 0])
        minv = torch.full((P, Q + 1), INF, dtype=torch.float32, device=dev)
        used = torch.zeros((P, Q + 1), dtype=torch.bool, device=dev)
        way = torch.zeros((P, Q + 1), dtype=torch.long, device=dev)
        j0 = torch.zeros(P, dtype=torch.long, device=dev)
        live = act.clone()
        for _ in range(2 * (Q + 1) + 1):
            if not live.any():
                break
            lv = live[:, None]
            used = used | ((cols == j0[:, None]) & lv)
            i0 = p[ar, j0]
            row = C[ar, i0]  # (P, Q + 1)
            dot = torch.where(bad - (~torch.isfinite(row)).long() > 0, torch.nan, row)
            u_i0 = ((rows == i0[:, None]).float() * u).sum(1)
            cur = (dot - u_i0[:, None]) - v
            upd = ~used & (cur < minv) & lv
            minv = torch.where(upd, cur, minv)
            way = torch.where(upd, j0[:, None], way)
            masked = torch.where(used, inf, minv)
            j1 = _first_argmin(masked)
            delta = masked[ar, j1][:, None]
            coef = torch.zeros_like(u).scatter_add_(1, p, used.float())
            u = torch.where(lv, u + delta * coef, u)
            v = torch.where(lv & used, v - delta, v)
            minv = torch.where(lv & ~used, minv - delta, minv)
            j0 = torch.where(live, j1, j0)
            live = live & (p[ar, j0] != 0)
        # backtrack, at most n + 1 steps a problem
        go = act & (j0 != 0)
        for _ in range(int(n.max()) + 1):
            if not go.any():
                break
            j1 = way[ar, j0]
            p[ar, j0] = torch.where(go, p[ar, j1], p[ar, j0])
            j0 = torch.where(go, j1, j0)
            go = go & (j0 != 0)
    # invert p: the column of each row; column 0 and free columns write row 0, dropped
    out = torch.zeros((P, T + 1), dtype=torch.long, device=dev)
    out.scatter_(1, p[:, 1:], (cols[1:] - 1).expand(P, Q).contiguous())
    out = out[:, 1:]
    return torch.where(rows[None, 1:] <= n[:, None], out, 0)


def assign(cost: torch.Tensor, valid: torch.Tensor, groups: int) -> torch.Tensor:
    """M1 on CUDA tensors: cost (S, B, T, G * Qg) f32, valid (B, T) bool ->
    (S, B, G, T) int64 global query indices; rows past min(sum(valid[b]), Qg)
    hold 0. One launch; the valid counts are read on the device."""
    S, B, T, QT = cost.shape
    Qg = QT // groups
    if cost.dtype != torch.float32 or valid.shape != (B, T) or QT % groups:
        raise ValueError(f"M1 takes a (S, B, T, G * Qg) float32 cost and (B, T) valid, got "
                         f"{cost.dtype} {tuple(cost.shape)}, {tuple(valid.shape)}, G={groups}")
    if Qg + 1 > 1024:
        raise ValueError(f"M1 takes Qg <= 1023 queries a group, got {Qg}")
    cost = cost.contiguous()
    valid = valid.to(device=cost.device, dtype=torch.bool).contiguous()
    out = torch.empty((S, B, groups, T), dtype=torch.long, device=cost.device)
    assignment_kernel(cost.data_ptr(), valid.data_ptr(), out.data_ptr(), S, B, T, groups, Qg)
    return out


def assign_plain(cost: torch.Tensor, valid: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version of `assign`, on any device: the (s, b, g) problems
    through `solve_assignment_plain`, the group offsets added on the valid rows."""
    S, B, T, QT = cost.shape
    Qg = QT // groups
    per = cost.reshape(S, B, T, groups, Qg).permute(0, 1, 3, 2, 4).reshape(-1, T, Qg)
    n = valid.long().sum(1).clamp(max=Qg)  # (B,)
    local = solve_assignment_plain(per, n[None, :, None].expand(S, B, groups).reshape(-1))
    offsets = torch.arange(groups, device=cost.device)[None, None, :, None] * Qg
    inside = torch.arange(T, device=cost.device) < n[:, None]  # (B, T)
    return torch.where(inside[None, :, None, :], local.reshape(S, B, groups, T) + offsets, 0)


def kernel_attributes() -> dict:
    """{registers, local_bytes, static_shared_bytes} of M1's kernel
    (`cudaFuncGetAttributes`); its dynamic shared memory is `shared_layout`'s."""
    fn = load("matcher.cu").lw_assignment_attributes
    fn.argtypes = [ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * 3)()
    err = fn(out)
    if err != 0:
        raise RuntimeError(f"M1 attributes: CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1], "static_shared_bytes": out[2]}


def shared_layout(T: int, Qg: int) -> dict:
    """{shared_bytes, staged_rows, budget_bytes} of an M1 launch at (T, Qg), as
    `csrc/matcher.cu` sizes it: u, p, way and the argmin's per-warp results,
    and the first cost rows that fit in the budget (the others it reads from L2)."""
    fn = load("matcher.cu").lw_assignment_shared
    fn.argtypes = [_I, _I, ctypes.POINTER(_I)]
    fn.restype = _I
    out = (_I * 3)()
    err = fn(T, Qg, out)
    if err != 0:
        raise RuntimeError(f"M1 shared layout at T={T}, Qg={Qg}: CUDA error {err}")
    return {"shared_bytes": out[0], "staged_rows": out[1], "budget_bytes": out[2]}


@trace.spanned("matcher")
@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor,
                    group_detr: int = 1, cost_class: float = 2.0, cost_bbox: float = 5.0,
                    cost_giou: float = 2.0, focal_alpha: float = 0.25) -> torch.Tensor:
    """Optimal assignment per (image, group), for any leading dims (e.g. a
    stack of output sets): pred_logits (..., B, G * Qg, K), pred_boxes
    (..., B, G * Qg, 4) -> matched_q (..., B, G, T) int64 on the inputs'
    device: the query index, global into G * Qg, assigned to each target slot.
    Meaningful only where tgt_valid; padded slots hold 0."""
    lead = pred_logits.shape[:-3]
    B, Qt, _ = pred_logits.shape[-3:]
    T = tgt_labels.shape[1]
    G = group_detr
    cost = match_cost_matrix(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                             cost_class, cost_bbox, cost_giou, focal_alpha)
    cost = cost.reshape(-1, B, T, Qt)  # (S, B, T, Qt)
    matched = (assign if cost.is_cuda else assign_plain)(cost, tgt_valid, G)
    return matched.reshape(*lead, B, G, T)
