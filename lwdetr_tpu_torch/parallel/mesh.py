"""Data parallelism over processes: DDP, and the ZeRO-1 plan.

Counterpart of `lwdetr_tpu/parallel/mesh.py`. The JAX package declares a
device mesh and lets XLA insert the collectives; the port runs one process a
card and places each collective itself:

* `make_mesh` -> the process group (`parallel/dist.py::init_distributed`).
* `shard_batch` -> each process's own loader rows: the loader strides the
  dataset by process (`data/loader.py`), and the JAX global batch is the
  processes' local batches in rank order (`--batch_size` is per process).
* `replicated` -> `wrap_ddp`: DistributedDataParallel averages the gradients
  over the processes in the backward, as the reference does
  (main.py:206-210). The train-mode BatchNorm statistics span the global
  batch (`models/projector.py`), `num_boxes` is the global count over the
  world size (`models/criterion.py`), and the drop masks are rows of one
  global draw (`models/drop.py::RankRows`).
* `zero1_sharding_tree` -> `zero1_plan`: the AdamW moments and the EMA of
  each planned leaf are kept and updated as one slice a process
  (`train/optim.py::ShardedAdamW`, `ema_shard`), the updated parameters
  all-gathered.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

ZERO1_MIN_SIZE = 16384


def wrap_ddp(model: nn.Module, device: torch.device) -> nn.Module:
    """`model` under DistributedDataParallel. `find_unused_parameters`: which
    parameters the forward leaves unread depends on the configuration (the
    learned position embedding, the encoder's unused taps), so DDP finds them
    each step rather than being promised one graph; the train step then gives
    them zero gradients (`optim.zero_missing_grads`). `broadcast_buffers` is
    off: the BatchNorm statistics are computed from all-reduced sums, so they
    are equal on every process without being re-sent each forward."""
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=True, broadcast_buffers=False)


def jax_dim0(cfg) -> Dict[str, int]:
    """Each reference key's dim 0 as the JAX package lays the leaf out (a
    Linear weight's input width, a convolution's kernel height; the layouts of
    `weights.py`'s mapping)."""
    from lwdetr_tpu_torch.weights import _flax_shape, build_mapping

    with torch.device("meta"):
        from lwdetr_tpu_torch.models.lwdetr import LWDETR

        shapes = {k: tuple(v.shape) for k, v in LWDETR(cfg).state_dict().items()}
    out = {}
    for key, _, _, kind in build_mapping(cfg):
        shape = _flax_shape(shapes[key], kind)
        if shape:
            out[key] = shape[0]
    return out


def zero1_plan(named: Mapping[str, torch.Tensor], world: int, dim0: Mapping[str, int],
               min_size: int = ZERO1_MIN_SIZE) -> Dict[str, int]:
    """{key: element count} of the leaves whose optimizer state and EMA are
    sharded over `world` processes: the JAX rule (`mesh.py:64`), ndim >= 1, at
    least `min_size` elements and dim 0 divisible by the world size, read on
    the JAX layout's dim 0 (`dim0`; a key it lacks, on its own), so that the
    same leaves are planned. A planned leaf's flattened storage is cut into
    `world` equal contiguous slices (its element count is a multiple of the
    world size, since its dim 0 is)."""
    plan = {}
    if world < 2:
        return plan
    for key, t in named.items():
        d0 = dim0.get(key, t.shape[0] if t.dim() else 1)
        if t.dim() >= 1 and t.numel() >= min_size and d0 % world == 0:
            plan[key] = t.numel()
    return plan


def shard_range(numel: int, world: int, rank: int) -> Tuple[int, int]:
    """[start, stop) of process `rank`'s slice of a planned leaf's elements."""
    per = numel // world
    return rank * per, (rank + 1) * per
