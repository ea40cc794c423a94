"""Compute-dtype weights from float32 parameters.

The port keeps every parameter and buffer in float32, as the JAX package
does ("parameters are always fp32", `lwdetr_tpu/config.py:133`), and
computes in the dtype of its activations: `build_model` records the compute
dtype as `LWDETR.compute_dtype` and the model casts its images to it. Each
layer casts a weight to the dtype of its input where it uses it, at the
place where the JAX module casts it; a fold (the softmax scale into the q
projection, a layer scale into an output projection) is formed in float32
and cast once.

`cast_params` builds such weights. Under autograd they are built at every
call (in float32 a cast is the parameter itself and a fold is formed as
before, so training and float32 results are unchanged bit for bit). When no
gradient is wanted (eval, `torch.no_grad`) they are built once and kept on the
module, keyed on the dtype and on each parameter's storage and `_version`,
the counter every in-place write bumps (`load_state_dict`, an optimizer step,
an EMA update): a changed parameter is rebuilt at the next call, and an
unchanged one costs the eager forward no cast launch. `Linear`, `Conv2d`,
`ConvTranspose2d` and `LayerNorm` are the `torch.nn` layers, with the same
parameters and state_dict keys, on top of it.
"""
from __future__ import annotations

from typing import Callable, Hashable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def cast_params(module: nn.Module, key: Hashable, dtype: torch.dtype,
                params: Sequence[torch.Tensor],
                make: Optional[Callable[[], Sequence[torch.Tensor]]] = None
                ) -> Tuple[torch.Tensor, ...]:
    """The tensors `make()` forms in float32 from `params` (default: `params`
    themselves), each cast to `dtype`; cached on `module` under `key` when no
    gradient is wanted."""
    def build():
        return tuple(t.to(dtype) for t in (params if make is None else make()))

    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return build()
    stamp = (dtype, *((p.data_ptr(), p._version) for p in params))
    cache = module.__dict__.setdefault("_cast_cache", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        with torch.no_grad():
            hit = cache[key] = (stamp, build())
    return hit[1]


def weight_and_bias(layer: nn.Module, dtype: torch.dtype):
    """(weight, bias or None) of a `torch.nn` layer in `dtype`."""
    if layer.bias is None:
        return cast_params(layer, "weight", dtype, (layer.weight,))[0], None
    return cast_params(layer, "weight_bias", dtype, (layer.weight, layer.bias))


class Linear(nn.Linear):
    """`nn.Linear` in the dtype of its input (the JAX package's `nn.Dense(dtype=...)`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, *weight_and_bias(self, x.dtype))


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` in the dtype of its input (`nn.Conv(dtype=...)`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, *weight_and_bias(self, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` in the dtype of its input (`nn.ConvTranspose(dtype=...)`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = weight_and_bias(self, x.dtype)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` whose statistics and affine run in float32 with the
    float32 weights, the result rounded once to the input's dtype: flax's
    `nn.LayerNorm(dtype=...)`. (The card's layer norm takes no float32
    weights beside bf16 input, so a bf16 input goes through float32.)"""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)
