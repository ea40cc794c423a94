"""Stochastic depth and dropout, with the masks drawn by a swappable source.

Counterparts of `_drop_path` (`lwdetr_tpu/models/vit.py:52-60`) and
`_dropout` (`lwdetr_tpu/models/transformer.py:34-43`): a site keeps an element
(dropout) or a whole row of the leading axis (stochastic depth) with
probability keep = 1 - rate and scales what it keeps by 1 / max(keep, 1e-8),
as x * mask / keep in the activations' dtype. A rate of exactly 0, or no
source (eval), draws nothing and returns x itself.

A source is any callable `source(keep, shape, like) -> mask` that returns a
0/1 mask of `shape` in `like`'s dtype on its device. `Bernoulli` draws the
masks from an explicit `torch.Generator` on the model's device, seeded per
train step (the JAX package folds the step into its key,
`lwdetr_tpu/train/engine.py:189`; the idea here is the same, the bits are
not). `Fed` hands out given masks in order, so that a test can feed the
same masks to the port and to the JAX package. With more than one process,
`RankRows` hands each process its rows of a draw at the global batch's
shape. A CUDA graph of the step (`train.engine.build_train_chain`) draws a
whole chain of steps with one `Bernoulli` whose generator it registers: each
replay draws the masks that the next eager step on that generator would.
Nothing here reads a value back to the host or copies one to the card, so a
graph can capture every draw. The sites draw in the JAX modules' order: per
ViT block the attention's then the MLP's; per decoder layer the
self-attention weights (a rate > 0 only), then the outputs of the
self-attention, the cross-attention, `linear1` (after the ReLU) and `linear2`.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

MaskSource = Callable[[float, Sequence[int], torch.Tensor], torch.Tensor]


def keep_of(rate) -> np.float32:
    """1 - rate in float32, as the JAX package forms it from its f32 rate."""
    return np.float32(1.0) - np.float32(rate)


class Bernoulli:
    """Masks bernoulli(keep) drawn with `generator` (on the model's device)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, keep, shape, like: torch.Tensor) -> torch.Tensor:
        probs = torch.full(tuple(shape), float(keep), device=like.device, dtype=torch.float32)
        return torch.bernoulli(probs, generator=self.generator).to(like.dtype)


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """A generator on `device` seeded from (seed, step): one stream a train step."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return gen


class RankRows:
    """A source for one of `world` processes: each mask is drawn by `source`
    at the global batch's shape (the leading axis `world` times the site's,
    which is batch-major at every site) and this process's rows are handed
    out, so that the processes' masks are the rows of one global draw, as the
    JAX step draws them for its global batch from one key. Each process
    draws the whole mask from the same stream."""

    def __init__(self, source: MaskSource, rank: int, world: int):
        self.source, self.rank, self.world = source, rank, world

    def __call__(self, keep, shape, like: torch.Tensor) -> torch.Tensor:
        n = shape[0]
        full = self.source(keep, (n * self.world,) + tuple(shape[1:]), like)
        return full[self.rank * n:(self.rank + 1) * n]


class Fed:
    """Given masks (numpy arrays or tensors on any device), handed out in
    order; each must have the shape its site asks for."""

    def __init__(self, masks: Iterable):
        self.masks = list(masks)
        self.used = 0

    def __call__(self, keep, shape, like: torch.Tensor) -> torch.Tensor:
        if self.used >= len(self.masks):
            raise IndexError(f"mask {self.used} asked for, {len(self.masks)} fed")
        m = self.masks[self.used]
        m = m if isinstance(m, torch.Tensor) else torch.as_tensor(np.asarray(m))
        if tuple(m.shape) != tuple(shape):
            raise ValueError(f"mask {self.used}: fed {tuple(m.shape)}, the site takes "
                             f"{tuple(shape)}")
        self.used += 1
        return m.to(device=like.device, dtype=like.dtype)


def draw(source: Optional[MaskSource], rate, shape, like: torch.Tensor):
    """(mask, keep as a 0-dim tensor in `like`'s dtype), or None when the site
    draws nothing (no source, or a rate of exactly 0)."""
    if source is None or float(rate) == 0.0:
        return None
    keep = keep_of(rate)
    mask = source(keep, shape, like)
    # filled on the device: a host scalar copied over would stop a graph capture
    return mask, torch.full((), max(float(keep), 1e-8), dtype=torch.float32,
                            device=like.device).to(like.dtype)


def apply(x: torch.Tensor, drawn) -> torch.Tensor:
    """x * mask / keep for a `draw` result, x for None."""
    if drawn is None:
        return x
    mask, keep = drawn
    return x * mask / keep


def drop_path_mask(source: Optional[MaskSource], rate, x: torch.Tensor):
    """The draw of one stochastic-depth site on the window-major buffer x: one
    mask a row of x's leading axis, (x.shape[0], 1, ..., 1), as the JAX mask."""
    return draw(source, rate, (x.shape[0],) + (1,) * (x.dim() - 1), x)


def dropout(x: torch.Tensor, rate, source: Optional[MaskSource]) -> torch.Tensor:
    """Element-wise dropout of x (x itself when nothing is drawn)."""
    return apply(x, draw(source, rate, x.shape, x))
