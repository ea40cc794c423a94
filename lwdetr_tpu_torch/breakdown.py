"""Where the device time of one eval step goes, on one CUDA card.

    python -m lwdetr_tpu_torch.breakdown --preset small --batch 32

Runs the step of `lwdetr_tpu_torch.bench` (forward + `post_process`,
seeded weights, images on the card) under `torch.profiler` for a few steps after warm-up, and prints
one JSON line: device time per step by kernel group (the port's kernels
K1-K4, GEMMs, convolutions, the rest), the top kernels by device time, and
the device's idle share of a step (1 - busy / step time, where busy is the
sum of kernel times under the profiler, kernels on one stream do not
overlap, and the step time is the mean over 15 steps timed without the
profiler, with CUDA events, since the profiler slows the host). The card's name and power limit are in
the line.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from lwdetr_tpu_torch.bench import make_step
from lwdetr_tpu_torch.config import PRESETS
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_ms

GROUPS = (
    ("K1 window_attention_bias", ("window_attention_bias_kernel",)),
    ("K2 flash_attention_cm", ("flash_attention_cm_kernel",)),
    ("K3 deform_attn_cm", ("deform_attn_cm_kernel",)),
    ("K4 deform_attn_sep", ("deform_attn_sep_kernel",)),
    # norms before convolutions: cuDNN's batch norm (`cudnn::bn_fw_inf_...`) is no convolution
    ("norm", ("layer_norm", "batch_norm", "bn_", "norm")),
    ("conv", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("topk/sort", ("topk", "sort", "radix", "gather")),
)


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other elementwise/copy"


def run(preset: str = "small", batch: int = 32, dtype: torch.dtype = torch.bfloat16,
        steps: int = 5) -> dict:
    step = make_step(preset, batch, dtype)
    with torch.no_grad():
        step_ms = measure_ms(step, iters=steps, warmup=3, repeats=3)["ms_mean"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = defaultdict(float)
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += evt.self_device_time_total / 1e3  # us -> ms
    busy = sum(kernels.values())
    groups = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name)] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "preset": preset, "batch": batch, "dtype": str(dtype).replace("torch.", ""),
        "steps": steps,
        "step_ms": step_ms,
        "profiled_wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "device_idle_share": 1.0 - busy / steps / step_ms,
        "groups_ms_per_step": {k: v / steps for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[name[:120], ms / steps] for name, ms in top],
        "device": torch.cuda.get_device_name(),
        "card": card_line(),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=tuple(PRESETS))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    return ap


def main() -> None:
    args = parser().parse_args()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    print(json.dumps(run(args.preset, args.batch, dtype)))


if __name__ == "__main__":
    main()
