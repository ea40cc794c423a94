"""Eval throughput of the port on one CUDA card.

    python -m lwdetr_tpu_torch.bench --preset small --batch 32

Prints one JSON line: the metric of the JAX package's `bench.py`
(`lwdetr_{preset}_640_bf16_infer_throughput_exact`, img/s/chip): batched
640x640 inference, forward + NMS-free exact top-k `post_process`, bf16
compute, images already on the device. The weights are drawn from a seed
(`weights.init_state_dict`): no step of the forward branches on them. The
line carries the card's name and power limit. Timing is `utils.timing`
(CUDA events) over 5 windows of 10 steps: the value is batch x 50 steps /
the summed time of the windows, so a stall in any step counts; the slowest
and fastest window stand beside it as the spread. `value_f32_host` (and its
spread) is the same forward fed f32 images, which the model casts to bf16
(the JAX tool's field of that name).
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import torch

from lwdetr_tpu_torch.config import PRESETS, get_config
from lwdetr_tpu_torch.models.lwdetr import build_model, post_process, resolve_device
from lwdetr_tpu_torch.models.transformer import BRANCHES, set_force_branch
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_ms
from lwdetr_tpu_torch.weights import init_state_dict


def make_forward(preset: str, dtype: torch.dtype, seed: int = 0,
                 force_branch: Optional[str] = None, device=None):
    """(model, forward): forward(images) is the timed step, forward +
    `post_process` of 640x640 images already on the card, with weights drawn
    from `seed`; `force_branch` sets the cross-attention's value layout
    (None: the default rule)."""
    device = resolve_device(device)
    cfg = get_config(preset)
    model = build_model(cfg, device, dtype, state_dict=init_state_dict(cfg, seed))
    set_force_branch(model, force_branch)

    def forward(images):
        out = model(images)
        sizes = torch.full((images.shape[0], 2), 640.0, device=images.device)
        return post_process(out["pred_logits"], out["pred_boxes"], sizes, cfg.num_select)

    return model, forward


def synthetic_images(batch: int, dtype: torch.dtype, device, seed: int = 0) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((batch, 640, 640, 3), generator=g, device=device).to(dtype)


def make_step(preset: str, batch: int, dtype: torch.dtype, seed: int = 0,
              force_branch: Optional[str] = None, host_dtype: Optional[torch.dtype] = None):
    """step(): `make_forward`'s forward on `batch` seeded images in `host_dtype`
    (default: the compute dtype)."""
    model, forward = make_forward(preset, dtype, seed, force_branch)
    images = synthetic_images(batch, host_dtype or dtype, next(model.parameters()).device, seed)
    return lambda: forward(images)


def run(preset: str = "small", batch: int = 32, force_branch: Optional[str] = None) -> dict:
    model, forward = make_forward(preset, torch.bfloat16, force_branch=force_branch)
    per_s = lambda ms: batch / (ms / 1000.0)  # noqa: E731
    t = {}
    for host in (torch.bfloat16, torch.float32):
        images = synthetic_images(batch, host, next(model.parameters()).device)
        with torch.no_grad():
            t[host] = measure_ms(forward, images, iters=10, warmup=3, repeats=5)
    f32h, t = t[torch.float32], t[torch.bfloat16]
    return {
        "metric": f"lwdetr_{preset}_640_bf16_infer_throughput_exact",
        "value": per_s(t["ms_mean"]),
        "unit": "img/s/chip",
        "value_spread": [per_s(t["ms_max"]), per_s(t["ms_min"])],
        "value_f32_host": per_s(f32h["ms_mean"]),
        "value_f32_host_spread": [per_s(f32h["ms_max"]), per_s(f32h["ms_min"])],
        "ms_per_batch": t["ms_mean"],
        "timed_steps": 10 * 5,
        "batch": batch,
        "force_branch": force_branch,
        "device": torch.cuda.get_device_name(),
        "card": card_line(),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=tuple(PRESETS))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--force_branch", default=None, choices=BRANCHES,
                    help="the cross-attention's value layout (default: cm under 4096 memory "
                         "positions, else sep)")
    return ap


def main() -> None:
    args = parser().parse_args()
    print(json.dumps(run(args.preset, args.batch, args.force_branch)))


if __name__ == "__main__":
    main()
