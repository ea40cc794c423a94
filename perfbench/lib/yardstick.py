"""The least time a step's attention and sampling could take on one H100.

The bytes and operations are a frozen copy of the program's kernel-table
formulas (`chip_smoke.py`), worked out here from the configuration's shapes
alone, so the count is the same whatever implements the work:

* attention over (batch, heads, N tokens, D channels): the forward's QK^T and
  PV, 4 batch heads N^2 D operations; its backward twice that (dQ, dK, dV and
  dP); bytes: q, k, v in and the output out (4 C N a row of the batch), in
  the backward q, k, v and d(out) in, d(q, k, v) out (7 C N);
* deformable sampling of Q queries, H heads of D channels, L levels and P
  points: 4 corners x (multiply + add) a channel, 8 B Q H D L P operations,
  twice that in the backward; bytes: the values at the distinct in-map
  positions that the points' bilinear corners name (D channels each, once;
  counted from the traced step's own sampling locations by
  `touched_positions`, since they depend on the points), the sampling
  locations and weights in, the output out, and in the backward the same
  positions, d(out), the locations and weights in, d(value) (every
  position), d(locations) and d(weights) out.

The least time is the larger of operations over the peak for the compute
dtype and bytes over the memory's rate, inputs and outputs counted once.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# dense peaks: bf16 tensor cores; float32 work at the TF32 tensor-core rate,
# which no float32 kernel can beat
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
MFU_PEAK = 989e12  # `mfu`'s divisor in every cell: the dense bf16 peak
ITEMSIZE = {"bfloat16": 2, "float32": 4}
EMBED = {"vit_tiny": 192, "vit_small": 384, "vit_base": 768}
VIT_HEADS = 12
PATCH = 16
LEVEL_STRIDE = {"P3": 8, "P4": 16, "P5": 32, "P6": 64}


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def attention_calls(model: dict, size: int, batch: int, train: bool):
    """[(batch, heads, N, D)] of one step's attention calls."""
    depth = model["vit_encoder_num_layers"]
    windows = len(set(model["window_block_indexes"]))
    C = EMBED[model["encoder"]]
    side = size // PATCH
    calls = [(batch * 16, VIT_HEADS, (side // 4) ** 2, C // VIT_HEADS)] * windows
    calls += [(batch, VIT_HEADS, side * side, C // VIT_HEADS)] * (depth - windows)
    groups = model["group_detr"] if train else 1
    calls += [(batch * groups, model["sa_nheads"], model["num_queries"],
               model["hidden_dim"] // model["sa_nheads"])] * model["dec_layers"]
    return calls


def attention_least_s(model: dict, size: int, batch: int, train: bool, dtype: str) -> float:
    isz = ITEMSIZE[dtype]
    total = 0.0
    for b, h, n, d in attention_calls(model, size, batch, train):
        c = h * d
        total += least_s(4.0 * b * h * n * n * d, 4.0 * b * c * n * isz, dtype)
        if train:
            total += least_s(8.0 * b * h * n * n * d, 7.0 * b * c * n * isz, dtype)
    return total


def memory_positions(model: dict, size: int) -> int:
    return sum((size // LEVEL_STRIDE[lvl]) ** 2 for lvl in model["projector_scale"])


def sampler_least_s(model: dict, size: int, batch: int, train: bool, dtype: str,
                    positions: Sequence[int]) -> float:
    """One step's sampling: `positions[i]` is the number of distinct (image,
    head, level, y, x) positions the i-th decoder layer's corners read."""
    isz = ITEMSIZE[dtype]
    B = batch
    Q = model["num_queries"] * (model["group_detr"] if train else 1)
    H, C = model["ca_nheads"], model["hidden_dim"]
    D = C // H
    L, P = len(model["projector_scale"]), model["dec_n_points"]
    points = B * Q * H * L * P
    flops = 8.0 * B * Q * H * D * L * P
    total = 0.0
    for named in positions:
        corners = named * D
        total += least_s(flops, (corners + points * 3 + B * Q * C) * isz, dtype)
        if train:
            value = B * memory_positions(model, size) * C
            total += least_s(2 * flops, (corners + B * Q * C + 2 * points * 3 + value) * isz,
                             dtype)
    return total


def touched_positions(loc, spatial_shapes) -> int:
    """Distinct (b, h, level, y, x) map positions that the bilinear corners of
    the points loc (B, Q, H, L, P, 2), normalised (x, y), fall on; corners
    outside the map read nothing (the kernel table's count, level by level)."""
    import torch

    B, _, H = loc.shape[:3]
    plane = (torch.arange(B, device=loc.device)[:, None, None, None] * H
             + torch.arange(H, device=loc.device)[None, None, :, None])  # (B, 1, H, 1)
    total = 0
    for lvl, (Hl, Wl) in enumerate(spatial_shapes):
        Hl, Wl = int(Hl), int(Wl)
        x0 = torch.floor(loc[:, :, :, lvl, :, 0].double() * Wl - 0.5)
        y0 = torch.floor(loc[:, :, :, lvl, :, 1].double() * Hl - 0.5)
        keys = []
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = x0 + dx, y0 + dy
                inside = (x >= 0) & (x < Wl) & (y >= 0) & (y < Hl)
                key = (plane * Hl + y.clamp(0, Hl - 1).long()) * Wl + x.clamp(0, Wl - 1).long()
                keys.append(key[inside])
        total += int(torch.unique(torch.cat(keys)).numel())
    return total


def step_flops(config: dict, mode: str, size: int, batch: int) -> float:
    """The reference's FLOPs of one step (`flops_per_image` of the
    configuration's file: forward for "infer", forward and backward for
    "train")."""
    return float(config["flops_per_image"][mode][str(size)]) * batch


def total_least(fn, model: dict, sizes: Iterable[int], batch: int, train: bool,
                dtype: str) -> float:
    return sum(fn(model, s, batch, train, dtype) for s in sizes)


def sampler_total_least(model: dict, sizes: Sequence[int], batch: int, train: bool, dtype: str,
                        positions: Sequence[int]) -> Optional[float]:
    """The traced steps' sampling, `positions` one a decoder layer of each
    step in turn; None where they do not come to that."""
    layers = model["dec_layers"]
    if len(positions) != layers * len(sizes):
        return None
    return sum(sampler_least_s(model, s, batch, train, dtype,
                               positions[k * layers:(k + 1) * layers])
               for k, s in enumerate(sizes))
