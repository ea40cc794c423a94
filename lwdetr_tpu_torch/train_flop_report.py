"""FLOPs of the whole train step, by class and by stage, on one CUDA card.

    python -m lwdetr_tpu_torch.train_flop_report --preset small --step_ms 50.0

Counterpart of the JAX package's `scripts/train_flop_report.py`: one train
step of `bench_train`'s recipe (the preset's release model and criterion on
a synthetic 640x640 batch, f32; batch: the release per-device batch unless
given; a bf16 step runs the same operators) is run once under
`torch.utils.flop_counter.FlopCounterMode` (`utils.benchmark.train_step_flops`):
the train-mode forward over every query group, the criterion and the
matcher's costs, the backward (the port's backward kernels are operators with
FLOP rules of their own), clipping, AdamW and the EMA. It prints GFLOPs by
class (GEMM, convolution, attention, deformable sampling) and by stage (the
forward's modules, the backward), and with `--step_ms` (a step time measured
on the card, e.g. by `bench_train --chain`) the TFLOP/s that time achieves.
`--device cpu` counts on the CPU (the count does not depend on the device).
"""
from __future__ import annotations

import argparse
from typing import Optional

from lwdetr_tpu_torch import bench_train
from lwdetr_tpu_torch.config import PRESETS, TRAIN_PRESETS
from lwdetr_tpu_torch.models.criterion import Targets
from lwdetr_tpu_torch.utils.benchmark import format_report, train_step_flops


def report(preset: str = "small", batch: Optional[int] = None, max_gt: int = 100,
           step_ms: Optional[float] = None, device=None) -> dict:
    """The train step's FLOP report (`train_step_flops`) with `preset`,
    `batch`, `tflops_per_s` (None without `step_ms`)."""
    batch = batch or TRAIN_PRESETS[preset].batch_size
    setup = bench_train.make_train_setup(preset, batch, device=device, max_gt=max_gt)
    state, data = setup.state, setup.data

    def forward():
        # the step's forward and criterion alone (no masks: a rate changes no FLOP)
        state.model.train()
        out = state.model(data["images"])
        return setup.criterion(out, Targets(data["labels"], data["boxes"], data["valid"]),
                               train=True)

    res = train_step_flops(bench_train.eager_step(setup), forward, type(state.model).__name__)
    return dict(res, preset=preset, batch=batch, step_ms=step_ms,
                tflops_per_s=None if not step_ms else res["total"] / (step_ms / 1e3) / 1e12)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=tuple(PRESETS))
    ap.add_argument("--batch", type=int, default=None,
                    help="default: the release per-device batch of --preset")
    ap.add_argument("--max_gt", type=int, default=100)
    ap.add_argument("--step_ms", type=float, default=None,
                    help="a measured step time: prints the TFLOP/s it achieves")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    return ap


def main() -> None:
    args = parser().parse_args()
    res = report(args.preset, args.batch, args.max_gt, args.step_ms, args.device)
    print(f"== train step FLOPs: {args.preset} @ batch {res['batch']} (640x640) ==")
    print(format_report(res, top=args.top))
    if res["tflops_per_s"] is not None:
        print(f"  @ {args.step_ms} ms/step -> {res['tflops_per_s']:.2f} TFLOP/s achieved")


if __name__ == "__main__":
    main()
