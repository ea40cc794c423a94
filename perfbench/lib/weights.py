"""The benchmark's weights: one state dict drawn from the seed on the device.

Both sides take the same tensors: the program builds its model from them and
the reference loads them. Every floating leaf is mean + std x a standard
normal draw; the draws of all leaves are one call on one generator, and the
means and scales are spread over the leaves by two more, so set-up makes no
call a leaf on the host. The scales keep a random network's activations near
unit size and its heads in the range a trained detector gives: linear and
convolution weights 1 / sqrt(fan_in), biases 0.02, norms' scales 1, the
ViT's layer scales 0.1, the class heads' biases at the 0.01 prior, the box
heads' last layers small, so that boxes stay inside the image.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def leaf_rule(name: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(mean, std) of the leaf `name`."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return 1.0, 0.0
    if leaf == "running_mean":
        return 0.0, 0.0
    if leaf in ("gamma_1", "gamma_2"):
        return 0.1, 0.0
    if leaf == "pos_embed":
        return 0.0, 0.02
    if name.endswith("refpoint_embed.weight"):
        return 0.0, 0.1
    if name.endswith("query_feat.weight"):
        return 0.0, 1.0
    is_norm = (".norm" in name or "_norm." in name or ".bn." in name
               or (name.split(".")[-2].isdigit() and len(shape) == 1 and ".stages." in name
                   and name.split(".")[-2] == "1"))
    if is_norm and leaf == "weight":
        return 1.0, 0.0
    if leaf in ("bias", "in_proj_bias", "q_bias", "v_bias"):
        if "class_embed" in name:
            return PRIOR_BIAS, 0.0
        return 0.0, 0.02
    fan_in = int(math.prod(shape[1:])) if len(shape) > 1 else int(shape[0])
    if "stages_sampling" in name and len(shape) == 4 and ".conv." not in name:
        fan_in = int(shape[0])  # a transposed convolution's weight is (in, out, k, k)
    std = 1.0 / math.sqrt(max(fan_in, 1))
    if ("bbox_embed" in name and ".layers.2." in name) or "sampling_offsets" in name:
        std *= 0.1  # box deltas and sampling offsets near zero
    if "attention_weights" in name:
        std *= 0.1
    return 0.0, std


def make_state_dict(shapes: List[Tuple[str, Tuple[int, ...], torch.dtype]], seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the reference's `state_shapes`, drawn on `device` from `seed`."""
    floats = [(n, s) for n, s, dt in shapes if dt.is_floating_point]
    sizes = [math.prod(s) for _, s in floats]
    rules = [leaf_rule(n, s) for n, s in floats]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(sizes)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    counts = torch.tensor(sizes, device=device)
    mean = torch.tensor([r[0] for r in rules], device=device).repeat_interleave(counts,
                                                                               output_size=total)
    std = torch.tensor([r[1] for r in rules], device=device).repeat_interleave(counts,
                                                                              output_size=total)
    flat = flat * std + mean
    out = dict(zip([n for n, _ in floats],
                   (p.view(s) for p, (_, s) in zip(flat.split(sizes), floats))))
    for n, s, dt in shapes:
        if not dt.is_floating_point:
            out[n] = torch.zeros(s, dtype=dt, device=device)
    return {n: out[n] for n, _, _ in shapes}
