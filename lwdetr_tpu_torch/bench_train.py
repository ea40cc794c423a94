"""Train-step throughput of the port on one CUDA card.

    python -m lwdetr_tpu_torch.bench_train --preset small --batch 4
    python -m lwdetr_tpu_torch.bench_train --preset xlarge --dtype bfloat16
    python -m lwdetr_tpu_torch.bench_train --preset large --grad_checkpointing

Measures the whole train step of `train.engine` (forward in train mode with
the preset's release stochastic-depth rate and dropout, Hungarian matching,
IA-BCE + L1 + GIoU over the last, auxiliary and encoder output sets,
backward, gradient clipping, AdamW, EMA) in `--dtype` (float32 default;
bfloat16 computes in bf16 with f32 parameters) on one synthetic batch:
640x640 images and `--gt_per_img` boxes an image padded to `--max_gt`,
weights drawn from a seed; the batch is the preset's release per-device
batch unless given (2 for large and xlarge). `--grad_checkpointing`
recomputes each ViT block in the backward. Prints one JSON line with the
metric `lwdetr_{preset}_640_{dtype}_train_throughput` in img/s, `step_ms`,
the host time the matcher takes per step, peak device memory
(`torch.cuda.max_memory_allocated`), and the card's name and power limit.
Timing: CUDA events around windows of `--steps` steps after 3 warm-up steps;
the value is the median window, the spread its fastest and slowest.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional
from unittest import mock

import torch

from lwdetr_tpu_torch.config import PRESETS, TRAIN_PRESETS, get_config, get_train_config
from lwdetr_tpu_torch.models import criterion as criterion_mod
from lwdetr_tpu_torch.models.criterion import SetCriterion
from lwdetr_tpu_torch.models.lwdetr import resolve_device
from lwdetr_tpu_torch.models.transformer import BRANCHES, set_force_branch
from lwdetr_tpu_torch.train.engine import build_train_step, create_train_state
from lwdetr_tpu_torch.train.optim import drop_scheduler
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_ms
from lwdetr_tpu_torch.weights import init_state_dict


def synthetic_batch(num_classes: int, batch: int, size: int, max_gt: int, gt_per_img: int,
                    device, seed: int = 0) -> dict:
    """One batch of random images and boxes, made on `device` from `seed`."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "images": torch.randn((batch, size, size, 3), generator=g, device=device),
        "labels": torch.randint(0, num_classes, (batch, max_gt), generator=g, device=device),
        "boxes": torch.rand((batch, max_gt, 4), generator=g, device=device) * 0.4 + 0.2,
        "valid": (torch.arange(max_gt, device=device) < gt_per_img).expand(batch, -1).contiguous(),
    }


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NITER_PER_EP = 1000


def make_train_step(preset: str, batch: int, device=None, seed: int = 0, max_gt: int = 100,
                    gt_per_img: int = 7, force_branch: Optional[str] = None,
                    dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False):
    """(state, step()) of `preset`'s release recipe on one synthetic 640x640
    batch (1000 steps an epoch, so the StepLR never drops in a benchmark),
    computing in `dtype`; each step takes the rates of the release drop
    schedules at its step count, with masks drawn afresh each step;
    `force_branch` sets the cross-attention's value layout (None: panels)."""
    device = resolve_device(device)
    mcfg = get_config(preset, grad_checkpointing=grad_checkpointing)
    tcfg = get_train_config(preset, max_gt=max_gt)
    state = create_train_state(mcfg, tcfg, niter_per_ep=NITER_PER_EP, device=device,
                               state_dict=init_state_dict(mcfg, seed), dtype=dtype)
    set_force_branch(state.model, force_branch)
    train_step = build_train_step(state, SetCriterion(mcfg, tcfg), tcfg,
                                  static_zero_drop_path=mcfg.drop_path == 0,
                                  static_zero_dropout=mcfg.dropout == 0, seed=seed)
    scheds = [drop_scheduler(rate, tcfg.epochs, NITER_PER_EP, tcfg.cutoff_epoch, tcfg.drop_mode,
                             tcfg.drop_schedule) for rate in (mcfg.drop_path, mcfg.dropout)]
    data = synthetic_batch(mcfg.num_classes, batch, 640, max_gt, gt_per_img, device, seed)
    return state, lambda: train_step(data, *(float(s[min(state.step, len(s) - 1)])
                                             for s in scheds))


class HostTimer:
    """Wraps a function and sums the host time spent inside it."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def run(preset: str = "small", batch: int = 4, steps: int = 10, repeats: int = 5,
        max_gt: int = 100, gt_per_img: int = 7, force_branch: Optional[str] = None,
        dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False) -> dict:
    state, step = make_train_step(preset, batch, max_gt=max_gt, gt_per_img=gt_per_img,
                                  force_branch=force_branch, dtype=dtype,
                                  grad_checkpointing=grad_checkpointing)
    torch.cuda.reset_peak_memory_stats()
    # the matcher's host time holds its wait for the forward and the scipy solves
    timer = HostTimer(criterion_mod.hungarian_match)
    with mock.patch.object(criterion_mod, "hungarian_match", timer):
        t = measure_ms(step, iters=steps, warmup=3, repeats=repeats)
    loss = float(step()["loss"])
    per_s = lambda ms: batch / (ms / 1000.0)  # noqa: E731
    return {
        "metric": f"lwdetr_{preset}_640_{'f32' if dtype == torch.float32 else 'bf16'}"
                  "_train_throughput",
        "value": per_s(t["ms"]),
        "unit": "img/s",
        "value_spread": [per_s(t["ms_max"]), per_s(t["ms_min"])],
        "step_ms": t["ms"],
        "step_ms_samples": t["samples"],
        "matcher_host_ms_per_step": timer.seconds * 1e3 / timer.calls,
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "steps_taken": state.step,
        "last_loss": loss,
        "batch": batch,
        "gt_per_img": gt_per_img,
        "force_branch": force_branch,
        "dtype": str(dtype).replace("torch.", ""),
        "grad_checkpointing": grad_checkpointing,
        "device": torch.cuda.get_device_name(),
        "card": card_line(),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=tuple(PRESETS))
    ap.add_argument("--batch", type=int, default=None,
                    help="default: the release per-device batch of --preset")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--max_gt", type=int, default=100)
    ap.add_argument("--gt_per_img", type=int, default=7, help="valid boxes per image")
    ap.add_argument("--force_branch", default=None, choices=BRANCHES,
                    help="the cross-attention's value layout (default: sep, the panels)")
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES),
                    help="compute dtype (the parameters stay float32)")
    ap.add_argument("--grad_checkpointing", action="store_true",
                    help="recompute each ViT block in the backward")
    return ap


def main() -> None:
    args = parser().parse_args()
    batch = args.batch or TRAIN_PRESETS[args.preset].batch_size
    print(json.dumps(run(args.preset, batch, args.steps, args.repeats, args.max_gt,
                         args.gt_per_img, args.force_branch, DTYPES[args.dtype],
                         args.grad_checkpointing)))


if __name__ == "__main__":
    main()
