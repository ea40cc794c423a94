"""Where the device time of one eval or train step goes, on one CUDA card.

    python -m lwdetr_tpu_torch.breakdown --preset small --batch 32
    python -m lwdetr_tpu_torch.breakdown --preset small --train
    python -m lwdetr_tpu_torch.breakdown --preset tiny --train --force_branch cm
    python -m lwdetr_tpu_torch.breakdown --preset xlarge --train --dtype bfloat16

Runs the step of `lwdetr_tpu_torch.bench` (forward + `post_process`,
seeded weights, images on the card) or, with `--train`, the train step of
`lwdetr_tpu_torch.bench_train` (f32 unless `--dtype` says otherwise, with
`--grad_checkpointing` if given; batch: the release per-device batch unless
given) under `torch.profiler` for a few steps after warm-up, and prints
one JSON line: device time per step by kernel group (the port's kernels
K1-K10 and M1, GEMMs, convolutions, the optimizer's and EMA's fused passes, the
rest), the top kernels by device time, the device time of the decoder's
head-major value copies (`value_panels`, the panel branch; profiler range
`VALUE_COPY_RANGE`), the host time the matcher takes per train step
(building the costs and enqueuing M1; its device time is the "M1 assignment"
group), and
the device's idle share of a step (1 - busy / step time, where busy is the
sum of kernel times under the profiler, kernels on one stream do not
overlap, and the step time is the mean over 15 steps timed without the
profiler, with CUDA events, since the profiler slows the host), and the peak
device memory (`torch.cuda.max_memory_allocated`) over the run. The card's
name and power limit are in the line.
"""
from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict
from typing import Optional
from unittest import mock

import torch
from torch.profiler import ProfilerActivity, profile

from lwdetr_tpu_torch import bench_train
from lwdetr_tpu_torch.bench import make_step
from lwdetr_tpu_torch.config import PRESETS, TRAIN_PRESETS
from lwdetr_tpu_torch.models.transformer import BRANCHES, VALUE_COPY_RANGE
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_ms

# (group, patterns): a kernel goes to the first group of which a pattern is
# found in its lower-cased name (`re.search`). The cases of one source that
# are kernels of their own differ in a template argument: `false` for no bias
# (K9, and K7 without a bias), the row-major layout (K10), so they come first.
GROUPS = (
    ("K9 window_attention (no bias)", (r"window_attention_bias_kernel<[^(]*false>",
                                       r"window_attention_mma_kernel<[^(]*false>")),
    ("K1 window_attention_bias", ("window_attention_bias_kernel", "window_attention_mma_kernel")),
    ("K2 flash_attention_cm", ("flash_attention_cm_kernel", "flash_attention_cm_mma_kernel")),
    # K8 launches its kernel and the pass that turns its d(value) channel-major
    ("K8 deform_attn_cm_bwd", ("deform_attn_cm_bwd_kernel", "position_to_channel_major")),
    ("K3 deform_attn_cm", ("deform_attn_cm_kernel",)),
    ("K10 deform_attn_rowmajor", (r"deform_attn_sep_kernel<[^(]*rowmajorlayout",
                                  r"deform_attn_sep_bf16_kernel<[^(]*rowmajorlayout")),
    ("K10 deform_attn_rowmajor_bwd", (r"deform_attn_sep_bwd_kernel<[^(]*rowmajorlayout",)),
    # bf16 K4 / K10 are a kernel of their own (they round as the TPU kernels do)
    ("K4 deform_attn_sep", ("deform_attn_sep_kernel", "deform_attn_sep_bf16_kernel")),
    ("K5 deform_attn_sep_bwd", ("deform_attn_sep_bwd_kernel",)),
    ("K6 flash_attention_cm_bwd", ("attention_bwd_dq_kernel", "attention_bwd_dkdv_kernel")),
    ("K7 window_attention_bwd (no bias)", (r"window_attention_bias_bwd_kernel<[^(]*false>",)),
    ("K7 window_attention_bias_bwd", ("window_attention_bias_bwd_kernel",)),
    ("M1 assignment", ("assignment_kernel",)),
    # AdamW, gradient clipping and the EMA run as fused passes over tensor lists
    ("optimizer/EMA (foreach)", ("multi_tensor_apply", "lpnorm")),
    # norms before convolutions: cuDNN's batch norm (`cudnn::bn_fw_inf_...`) is no convolution
    ("norm", ("layer_norm", "batch_norm", "bn_", "norm")),
    ("conv", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("topk/sort", ("topk", "sort", "radix", "gather")),
)


ANNOTATIONS = ("Optimizer.", "ProfilerStep", "## ")
# --dtype: the names of bench_train, and the short names this tool took before
DTYPES = dict(bench_train.DTYPES, f32=torch.float32, bf16=torch.bfloat16)


def _group(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(re.search(k, low) for k in keys):
            return label
    return "other elementwise/copy"


def run(preset: str = "small", batch: int = 32, dtype: torch.dtype = torch.bfloat16,
        steps: int = 5, train: bool = False, force_branch: Optional[str] = None,
        grad_checkpointing: bool = False) -> dict:
    torch.cuda.reset_peak_memory_stats()
    if train:
        _, step = bench_train.make_train_step(preset, batch, force_branch=force_branch,
                                              dtype=dtype, grad_checkpointing=grad_checkpointing)
    else:
        step = make_step(preset, batch, dtype, force_branch=force_branch)
    matcher = bench_train.HostTimer(bench_train.criterion_mod.hungarian_match)
    with torch.set_grad_enabled(train), \
            mock.patch.object(bench_train.criterion_mod, "hungarian_match", matcher):
        step_ms = measure_ms(step, iters=steps, warmup=3, repeats=3)["ms_mean"]
        matcher_ms = matcher.seconds * 1e3 / max(matcher.calls, 1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = defaultdict(float)
    value_copy_ms = 0.0
    for evt in prof.key_averages():
        if evt.key == VALUE_COPY_RANGE and evt.device_type == torch.autograd.DeviceType.CPU:
            value_copy_ms += evt.device_time_total / 1e3  # the kernels launched inside the range
        # device events only, and no annotation mirrored onto the device's
        # timeline (`Optimizer.step#AdamW.step` spans the kernels it encloses)
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and not evt.key.startswith(ANNOTATIONS)):
            kernels[evt.key] += evt.self_device_time_total / 1e3  # us -> ms
    busy = sum(kernels.values())
    groups = defaultdict(float)
    for name, ms in kernels.items():
        groups[_group(name)] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "preset": preset, "batch": batch, "dtype": str(dtype).replace("torch.", ""),
        "mode": "train" if train else "eval", "force_branch": force_branch,
        "steps": steps,
        "matcher_host_ms_per_step": matcher_ms if train else None,
        "step_ms": step_ms,
        "profiled_wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy / steps,
        "device_idle_share": 1.0 - busy / steps / step_ms,
        "groups_ms_per_step": {k: v / steps for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[name[:120], ms / steps] for name, ms in top],
        "value_panels_copy_ms_per_step": value_copy_ms / steps,
        "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20,
        "grad_checkpointing": grad_checkpointing,
        "device": torch.cuda.get_device_name(),
        "card": card_line(),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=tuple(PRESETS))
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 32 for eval, the release per-device batch for --train")
    ap.add_argument("--dtype", default=None, choices=tuple(DTYPES),
                    help="default: bfloat16 for eval, float32 for --train")
    ap.add_argument("--train", action="store_true", help="profile the train step")
    ap.add_argument("--grad_checkpointing", action="store_true",
                    help="--train: recompute each ViT block in the backward")
    ap.add_argument("--force_branch", default=None, choices=BRANCHES,
                    help="the cross-attention's value layout (default: cm in eval under 4096 "
                         "memory positions, else sep)")
    return ap


def main() -> None:
    args = parser().parse_args()
    if args.train:
        dtype = DTYPES[args.dtype or "float32"]
        batch = args.batch or TRAIN_PRESETS[args.preset].batch_size
    else:
        dtype = DTYPES[args.dtype or "bfloat16"]
        batch = args.batch or 32
    print(json.dumps(run(args.preset, batch, dtype, train=args.train,
                         force_branch=args.force_branch,
                         grad_checkpointing=args.grad_checkpointing)))


if __name__ == "__main__":
    main()
