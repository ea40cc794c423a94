"""Exact torch-style bicubic interpolation as static matrices.

The reference resizes the pretrained 224-grid position embedding with
``F.interpolate(mode='bicubic', align_corners=False)``. The JAX package
builds that interpolation as two (dst, src) matrices in numpy
(`lwdetr_tpu/ops/resize.py`); the port keeps the same matrices so that both
packages resize with the same arithmetic.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch's bicubic uses a=-0.75)."""
    at = np.abs(t)
    at2 = at * at
    at3 = at2 * at
    return np.where(
        at <= 1.0,
        (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=None)
def bicubic_resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) matrix M with out = M @ in along one axis, matching torch
    F.interpolate(mode='bicubic', align_corners=False). Read-only."""
    M = np.zeros((dst, src), dtype=np.float64)
    if src == dst:
        np.fill_diagonal(M, 1.0)
    else:
        scale = src / dst
        for i in range(dst):
            x = (i + 0.5) * scale - 0.5
            x0 = int(np.floor(x))
            t = x - x0
            idx = np.clip(np.array([x0 - 1, x0, x0 + 1, x0 + 2]), 0, src - 1)
            w = _cubic_kernel(np.array([t + 1.0, t, t - 1.0, t - 2.0]))
            for j, wj in zip(idx, w):
                M[i, j] += wj
    M = M.astype(np.float32)
    M.setflags(write=False)
    return M


def bicubic_resize_2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bicubic-resize (..., H, W, C) -> (..., H', W', C), torch semantics."""
    h, w = x.shape[-3], x.shape[-2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    Mh = torch.from_numpy(bicubic_resize_matrix(h, oh).copy()).to(x.device, x.dtype)
    Mw = torch.from_numpy(bicubic_resize_matrix(w, ow).copy()).to(x.device, x.dtype)
    x = torch.einsum("Hh,...hwc->...Hwc", Mh, x)
    return torch.einsum("Ww,...hwc->...hWc", Mw, x)


def nearest_resize_index(src: int, dst: int) -> np.ndarray:
    """Index vector matching torch F.interpolate(mode='nearest')."""
    return np.minimum((np.arange(dst) * src // dst), src - 1).astype(np.int32)
