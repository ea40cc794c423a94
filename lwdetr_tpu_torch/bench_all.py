"""Eval throughput and batch-1 latency of every preset on one CUDA card.

    python -m lwdetr_tpu_torch.bench_all [--sizes tiny small ...] [--batch 32]

Counterpart of the JAX package's `scripts/bench_all.py`: each preset at
640x640 in bf16 with seeded weights (`bench.make_forward`: forward + exact
top-k `post_process`, images already on the card), one JSON line a preset:

* `value` (img/s), `batch_ms` and its spread: `--batch` images a step,
  `utils.timing.measure_ms` (median of 5 windows of 10 steps);
* `bs1_ms` and its spread: one image a step, timed the same way, host
  dispatch included;
* `bs1_device_ms` and its spread: the batch-1 step captured once as a CUDA
  graph (`utils.graphs.GuardedGraph`) and replayed `GRAPH_REPLAYS` times back
  to back between two CUDA events, 5 times: the device's time with no host
  work between forwards (the JAX tool chains K = 20 forwards in one jit);
* `bs1_dispatch_overhead_ms`: `bs1_ms` - `bs1_device_ms`;
* `ref_trt_fp16_ms_bs1`: the reference's TensorRT fp16 batch-1 latency, as
  its README gives it (measured on an NVIDIA T4, not on this card);

and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import torch

from lwdetr_tpu_torch.bench import make_forward, synthetic_images
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.graphs import GuardedGraph
from lwdetr_tpu_torch.utils.timing import measure_ms

# the reference's TensorRT fp16 total latency at batch 1 (its README; an NVIDIA T4)
BASELINE_TRT_MS = {"tiny": 2.0, "small": 2.9, "medium": 5.6, "large": 8.8, "xlarge": 19.1}
GRAPH_REPLAYS = 20
SIZES = ("tiny", "small", "medium", "large", "xlarge")


def graph_ms(graph: GuardedGraph, replays: int = GRAPH_REPLAYS, repeats: int = 5) -> List[float]:
    """ms a replay of `repeats` samples, each `replays` replays back to back
    between two CUDA events."""
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / replays)
    return samples


def batch1_graph(model, forward, images) -> GuardedGraph:
    """`forward(images)` under no_grad captured as a graph guarded by the
    model's parameters."""
    def call():
        with torch.no_grad():
            return forward(images)

    return GuardedGraph(call, list(model.parameters()))


def bench_size(size: str, batch: int = 32) -> Dict[str, object]:
    model, forward = make_forward(size, torch.bfloat16)
    device = next(model.parameters()).device
    with torch.no_grad():
        t_batch = measure_ms(forward, synthetic_images(batch, torch.bfloat16, device),
                             iters=10, warmup=3, repeats=5)
        img1 = synthetic_images(1, torch.bfloat16, device)
        t_bs1 = measure_ms(forward, img1, iters=10, warmup=3, repeats=5)
    samples = sorted(graph_ms(batch1_graph(model, forward, img1)))
    dev_ms = samples[len(samples) // 2]
    return {
        "metric": f"lwdetr_{size}_640_bf16_infer_throughput",
        "value": batch / (t_batch["ms"] / 1000.0),
        "unit": "img/s",
        "batch": batch,
        "batch_ms": t_batch["ms"],
        "batch_ms_spread": [t_batch["ms_min"], t_batch["ms_max"]],
        "bs1_ms": t_bs1["ms"],
        "bs1_ms_spread": [t_bs1["ms_min"], t_bs1["ms_max"]],
        "bs1_device_ms": dev_ms,
        "bs1_device_ms_spread": [samples[0], samples[-1]],
        "bs1_dispatch_overhead_ms": t_bs1["ms"] - dev_ms,
        "ref_trt_fp16_ms_bs1": BASELINE_TRT_MS[size],
        "ref_trt_device": "NVIDIA T4 (the reference's README)",
        "device": torch.cuda.get_device_name(),
        "card": card_line(),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", nargs="+", default=list(SIZES), choices=SIZES)
    ap.add_argument("--batch", type=int, default=32)
    return ap


def main() -> None:
    args = parser().parse_args()
    for size in args.sizes:
        print(json.dumps(bench_size(size, args.batch)), flush=True)


if __name__ == "__main__":
    main()
