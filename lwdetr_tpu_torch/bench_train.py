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
the host time the matcher takes per step (building the costs and enqueuing
M1: it does not wait for the device), M1's device time on one step's costs
(a CUDA graph of its launches), peak device memory
(`torch.cuda.max_memory_allocated`), and the card's name and power limit.
Timing: CUDA events around windows of `--steps` steps after 3 warm-up steps;
the value is the median window, the spread its fastest and slowest;
`step_ms_samples` are the windows' ms a step sorted, `step_ms_chron` in the
order they ran (the JAX tool's fields).

    python -m lwdetr_tpu_torch.bench_train --preset large --dtype bfloat16 --chain 10

`--chain N` (the JAX tool's: N steps in one program, no per-step dispatch)
captures the step once as a CUDA graph (`train.engine.build_train_chain`,
after 2 eager warm-up steps) and times windows of N replays back to back
between CUDA events, after one untimed window: the device's time a step with
no host work between steps. The drop rates are the schedule's at the chain's
first step (the release schedules are constant); the matcher's host time is
null, since a replay has none. `--host_dtype bf16` feeds bf16 images (the
JAX tool's: what its loader feeds a bf16 model); the JAX tool always builds
a bf16 model, so `--dtype float32` refuses it.
"""
from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace
from typing import Optional
from unittest import mock

import torch

from lwdetr_tpu_torch.config import PRESETS, TRAIN_PRESETS, get_config, get_train_config
from lwdetr_tpu_torch.models import criterion as criterion_mod
from lwdetr_tpu_torch.models import matcher as matcher_mod
from lwdetr_tpu_torch.models.criterion import SetCriterion
from lwdetr_tpu_torch.models.lwdetr import resolve_device
from lwdetr_tpu_torch.models.transformer import BRANCHES, set_force_branch
from lwdetr_tpu_torch.train.engine import (build_train_chain, build_train_step,
                                           create_train_state)
from lwdetr_tpu_torch.train.optim import drop_scheduler
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_graph_ms, measure_ms
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
HOST_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
NITER_PER_EP = 1000
CHAIN_WARMUP = 2  # eager steps before the capture


def check_host_dtype(dtype: torch.dtype, host_dtype: torch.dtype) -> None:
    """bf16 images go to a bf16 model only (the JAX tool's model is bf16)."""
    if host_dtype == torch.bfloat16 and dtype != torch.bfloat16:
        raise ValueError("--host_dtype bf16 feeds bf16 images to a bf16 model, as the JAX tool "
                         f"does (its model is always bf16); this model computes in {dtype}: "
                         "pass --dtype bfloat16")


def make_train_setup(preset: str, batch: int, device=None, seed: int = 0, max_gt: int = 100,
                     gt_per_img: int = 7, force_branch: Optional[str] = None,
                     dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False,
                     host_dtype: torch.dtype = torch.float32, niter_per_ep: int = NITER_PER_EP,
                     lr_drop: Optional[int] = None) -> SimpleNamespace:
    """`preset`'s release recipe on one synthetic 640x640 batch (images in
    `host_dtype`; 1000 steps an epoch, so the StepLR never drops in a
    benchmark, unless `niter_per_ep` / `lr_drop` say otherwise), computing in
    `dtype`: the train state, criterion, configs, batch and the drop
    schedules; `force_branch` sets the cross-attention's value layout (None:
    panels)."""
    check_host_dtype(dtype, host_dtype)
    device = resolve_device(device)
    mcfg = get_config(preset, grad_checkpointing=grad_checkpointing)
    tcfg = get_train_config(preset, max_gt=max_gt, **({} if lr_drop is None else
                                                      {"lr_drop": lr_drop}))
    state = create_train_state(mcfg, tcfg, niter_per_ep=niter_per_ep, device=device,
                               state_dict=init_state_dict(mcfg, seed), dtype=dtype)
    set_force_branch(state.model, force_branch)
    scheds = [drop_scheduler(rate, tcfg.epochs, niter_per_ep, tcfg.cutoff_epoch, tcfg.drop_mode,
                             tcfg.drop_schedule) for rate in (mcfg.drop_path, mcfg.dropout)]
    data = synthetic_batch(mcfg.num_classes, batch, 640, max_gt, gt_per_img, device, seed)
    data["images"] = data["images"].to(host_dtype)
    return SimpleNamespace(state=state, criterion=SetCriterion(mcfg, tcfg), mcfg=mcfg, tcfg=tcfg,
                           data=data, scheds=scheds, seed=seed, niter_per_ep=niter_per_ep,
                           static=dict(static_zero_drop_path=mcfg.drop_path == 0,
                                       static_zero_dropout=mcfg.dropout == 0))


def rates_at(setup: SimpleNamespace, step: int):
    """(drop-path rate, dropout rate) of the release schedules at `step`."""
    return tuple(float(s[min(step, len(s) - 1)]) for s in setup.scheds)


def make_train_step(preset: str, batch: int, device=None, seed: int = 0, max_gt: int = 100,
                    gt_per_img: int = 7, force_branch: Optional[str] = None,
                    dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False,
                    host_dtype: torch.dtype = torch.float32):
    """(state, step()) of `make_train_setup`'s recipe: each step takes the rates
    of the release drop schedules at its step count, with masks drawn afresh
    each step."""
    setup = make_train_setup(preset, batch, device, seed, max_gt, gt_per_img, force_branch,
                             dtype, grad_checkpointing, host_dtype)
    return setup.state, eager_step(setup)


def eager_step(setup: SimpleNamespace):
    """step(): `build_train_step` on `setup`'s batch at the schedules' rates of
    its step count."""
    train_step = build_train_step(setup.state, setup.criterion, setup.tcfg, seed=setup.seed,
                                  **setup.static)
    return lambda: train_step(setup.data, *rates_at(setup, setup.state.step))


def make_train_chain(setup: SimpleNamespace, mask_source=None):
    """`build_train_chain` of `setup`'s step at the drop rates of the state's
    current step (the chain keeps them)."""
    return build_train_chain(setup.state, setup.criterion, setup.tcfg, setup.data,
                             setup.niter_per_ep,
                             *rates_at(setup, setup.state.step), mask_source=mask_source,
                             warmup=CHAIN_WARMUP, **setup.static)


def chain_ms(chain, steps: int, repeats: int):
    """ms a step of `repeats` windows of `steps` replays each, between CUDA
    events, after one untimed window (chronological)."""
    chain(steps)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain(steps)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / steps)
    return samples


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


def matcher_device_ms(step) -> Optional[float]:
    """M1's device time a launch on the costs of one call of `step`: its
    launches replayed from a CUDA graph; None when the step launched none."""
    seen = []

    def record(*args):
        seen.append(args)
        return assign(*args)

    assign = matcher_mod.assign
    with mock.patch.object(matcher_mod, "assign", record):
        step()
    if not seen:
        return None
    return measure_graph_ms(lambda: assign(*seen[-1]), iters=20, repeats=3)["ms"]


def run(preset: str = "small", batch: int = 4, steps: int = 10, repeats: int = 5,
        max_gt: int = 100, gt_per_img: int = 7, force_branch: Optional[str] = None,
        dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False, chain: int = 0,
        host_dtype: torch.dtype = torch.float32) -> dict:
    setup = make_train_setup(preset, batch, max_gt=max_gt, gt_per_img=gt_per_img,
                             force_branch=force_branch, dtype=dtype,
                             grad_checkpointing=grad_checkpointing, host_dtype=host_dtype)
    state = setup.state
    step = eager_step(setup)
    torch.cuda.reset_peak_memory_stats()
    matcher_host_ms = None
    if chain:
        graph = make_train_chain(setup)
        samples = chain_ms(graph, chain, repeats)
        loss = float(graph(1)["loss"])
    else:
        # the matcher's host time: building the costs and enqueuing M1, no wait
        timer = HostTimer(criterion_mod.hungarian_match)
        with mock.patch.object(criterion_mod, "hungarian_match", timer):
            samples = measure_ms(step, iters=steps, warmup=3, repeats=repeats)["samples"]
        matcher_host_ms = timer.seconds * 1e3 / timer.calls
        loss = float(step()["loss"])
    m1_ms = matcher_device_ms(step)
    ordered = sorted(samples)
    ms = ordered[len(ordered) // 2]
    per_s = lambda ms: batch / (ms / 1000.0)  # noqa: E731
    return {
        "metric": f"lwdetr_{preset}_640_{'f32' if dtype == torch.float32 else 'bf16'}"
                  "_train_throughput",
        "value": per_s(ms),
        "unit": "img/s",
        "value_spread": [per_s(ordered[-1]), per_s(ordered[0])],
        "step_ms": ms,
        "step_ms_spread": [ordered[0], ordered[-1]],
        "step_ms_samples": ordered,
        "step_ms_chron": samples,
        "chain": chain,
        "host_dtype": "bf16" if host_dtype == torch.bfloat16 else "f32",
        "matcher_host_ms_per_step": matcher_host_ms,
        "matcher_device_ms_per_step": m1_ms,
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
    ap.add_argument("--chain", type=int, default=0,
                    help="time windows of N replays of the step captured as one CUDA graph: "
                         "the device's step time with no per-step dispatch")
    ap.add_argument("--host_dtype", choices=tuple(HOST_DTYPES), default="f32",
                    help="image dtype fed from the host (bf16 needs --dtype bfloat16)")
    return ap


def main() -> None:
    args = parser().parse_args()
    check_host_dtype(DTYPES[args.dtype], HOST_DTYPES[args.host_dtype])
    batch = args.batch or TRAIN_PRESETS[args.preset].batch_size
    print(json.dumps(run(args.preset, batch, args.steps, args.repeats, args.max_gt,
                         args.gt_per_img, args.force_branch, DTYPES[args.dtype],
                         args.grad_checkpointing, args.chain, HOST_DTYPES[args.host_dtype])))


if __name__ == "__main__":
    main()
