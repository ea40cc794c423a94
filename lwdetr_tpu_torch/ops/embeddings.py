"""Sinusoidal positional embeddings (counterpart of lwdetr_tpu/ops/embeddings.py).

* `sine_position_embedding`: image-grid embedding from the padding mask by
  cumulative sums, normalized to [0, 2pi] (reference position_encoding.py).
* `query_sine_embed`: per-query embedding of (cx, cy[, w, h]) reference
  points (reference transformer.py).

Both interleave (sin, cos) pairs over a temperature-10000 frequency ladder,
channel-last.
"""
from __future__ import annotations

import math

import torch


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    s = torch.sin(pos[..., 0::2])
    c = torch.cos(pos[..., 1::2])
    return torch.stack([s, c], dim=-1).flatten(-2)


def _dim_t(num_pos_feats: int, temperature: float, device) -> torch.Tensor:
    i = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2.0 * torch.floor(i / 2.0) / num_pos_feats)


def sine_position_embedding(mask: torch.Tensor, num_pos_feats: int = 128,
                            temperature: float = 10000.0, normalize: bool = True,
                            scale: float | None = None) -> torch.Tensor:
    """mask (B, H, W) bool, True on padded pixels -> (B, H, W, 2*num_pos_feats)
    float32, channels ordered [y-emb, x-emb]."""
    if scale is None:
        scale = 2.0 * math.pi
    not_mask = (~mask).to(torch.float32)
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, mask.device)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    return torch.cat([_interleave_sin_cos(pos_y), _interleave_sin_cos(pos_x)], dim=-1)


def query_sine_embed(pos: torch.Tensor, dim: int = 128) -> torch.Tensor:
    """pos (..., 2) or (..., 4) normalized (cx, cy[, w, h]) -> (..., 2*dim)
    ordered [y, x] or (..., 4*dim) ordered [y, x, w, h]."""
    scale = 2.0 * math.pi
    dim_t = _dim_t(dim, 10000.0, pos.device)

    def emb(coord):
        return _interleave_sin_cos(coord[..., None] * scale / dim_t)

    pos_x = emb(pos[..., 0])
    pos_y = emb(pos[..., 1])
    if pos.shape[-1] == 2:
        return torch.cat([pos_y, pos_x], dim=-1)
    if pos.shape[-1] == 4:
        return torch.cat([pos_y, pos_x, emb(pos[..., 2]), emb(pos[..., 3])], dim=-1)
    raise ValueError(f"pos last dim must be 2 or 4, got {pos.shape[-1]}")
