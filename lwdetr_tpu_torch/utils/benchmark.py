"""Startup self-benchmark and the train step's FLOPs: parameters, FLOPs by
class and by stage, latency.

Counterpart of `lwdetr_tpu/utils/benchmark.py::benchmark_model` (`:57`) and
`utils/hlo_report.py` (`detailed_flops :201`, `format_report :226`), which
read the FLOPs off the compiled XLA program. Here
`torch.utils.flop_counter.FlopCounterMode` counts them at the operators that
run, over one eval forward (`benchmark_model`) or one whole train step
(`train_step_flops`): PyTorch's own rules for the GEMMs (`mm`, `addmm`,
`bmm`, ...) and the convolutions (and their backward), and the rules below
for the port's kernels, registered on their `torch.ops.lwdetr.*` operators:

* attention (K1 / K9 `window_attention[_bias]`, K2 `flash_attention_cm`):
  QK^T and PV, 2 x B x N x N x C each, 4 B N^2 C in all (C the output's
  channels: heads x head_dim); their backwards (K7 / K7nb
  `window_attention[_bias]_bwd`, K6 `flash_attention_cm_bwd`): dQ, dK, dV
  and dP, 8 B N^2 C, twice the forward;
* deformable sampling (K3 `ms_deform_attn_cm`, K4 `ms_deform_attn_sep_panels`,
  K10 `ms_deform_attn`): 4 bilinear corners a sampling point, one
  multiply-add each with the attention weight folded into the corner
  weight, so 8 FLOPs an output element a (level, point); their backwards
  (K8, K5, K10b: `*_bwd`), an output element a (level, point): d(value) 8
  (the d(out) times each corner's weight, added), d(weights) 10 (the sample
  again, 8, then its product with d(out), summed, 2), d(loc) 20 (each axis:
  the corners weighted by the other axis's weights and the signs of the
  derivative, 8, then the product with d(out), summed, 2), 38 in all.

Each is reported as its own class beside GEMM and convolution, and every
class by stage, the first two named levels of the module path (the JAX
report's `flops_by_stage`); what runs outside the model (the criterion, the
matcher's costs, clipping, the optimizer, the EMA) is the stage
`(outside the model)`. A train step's stages are the forward's
(`forward/...`: the train-mode forward and the criterion, counted alone) and
`backward`, the rest of the step by class (`train_step_flops`). Latency: 5
warm-up calls and 20 timed ones, each between two CUDA events on the card (the
host clock on the CPU); the median, mean and p95 ms and the images a second at
the median.
"""
from __future__ import annotations

import time
from collections import defaultdict
from math import prod
from typing import Callable, Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from lwdetr_tpu_torch.ops import deform_attn as _deform_attn  # noqa: F401  (defines the operators)
from lwdetr_tpu_torch.ops import flash_attention as _flash_attention  # noqa: F401

ATTENTION_OPS = ("window_attention_bias", "window_attention", "flash_attention_cm",
                 "window_attention_bias_bwd", "window_attention_bwd", "flash_attention_cm_bwd")
SAMPLER_OPS = ("ms_deform_attn_cm", "ms_deform_attn_sep_panels", "ms_deform_attn",
               "ms_deform_attn_cm_bwd", "ms_deform_attn_sep_panels_bwd", "ms_deform_attn_bwd")
GEMM_OPS = ("mm", "addmm", "bmm", "baddbmm")
CONV_OPS = ("convolution", "_convolution", "convolution_backward")
OUTSIDE = "(outside the model)"
SAMPLER_BWD_FLOPS = 8 + 10 + 20  # d(value), d(weights), d(loc): an output element a point


def attention_flops(qkv_shape) -> int:
    """QK^T and PV of attention over channel-major qkv (B, 3C, N)."""
    B, ZC, N = qkv_shape
    return 4 * B * N * N * (ZC // 3)


def sampler_flops(out_shape, loc_shape) -> int:
    """8 FLOPs an output element a sampling point; loc (B, Q, H, L, P, 2)."""
    return 8 * prod(out_shape) * loc_shape[3] * loc_shape[4]


def sampler_bwd_flops(dout_shape, loc_shape) -> int:
    """SAMPLER_BWD_FLOPS an output element a sampling point."""
    return SAMPLER_BWD_FLOPS * prod(dout_shape) * loc_shape[3] * loc_shape[4]


@register_flop_formula([torch.ops.lwdetr.window_attention_bias, torch.ops.lwdetr.window_attention,
                        torch.ops.lwdetr.flash_attention_cm])
def _attention_formula(qkv_shape, *args, out_shape=None, **kwargs) -> int:
    return attention_flops(qkv_shape)


@register_flop_formula([torch.ops.lwdetr.ms_deform_attn_cm,
                        torch.ops.lwdetr.ms_deform_attn_sep_panels, torch.ops.lwdetr.ms_deform_attn])
def _sampler_formula(value_shape, spatial_shapes, loc_shape, *args, out_shape=None,
                     **kwargs) -> int:
    return sampler_flops(out_shape, loc_shape)


@register_flop_formula([torch.ops.lwdetr.window_attention_bias_bwd,
                        torch.ops.lwdetr.window_attention_bwd,
                        torch.ops.lwdetr.flash_attention_cm_bwd])
def _attention_bwd_formula(qkv_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * attention_flops(qkv_shape)


@register_flop_formula([torch.ops.lwdetr.ms_deform_attn_cm_bwd,
                        torch.ops.lwdetr.ms_deform_attn_sep_panels_bwd,
                        torch.ops.lwdetr.ms_deform_attn_bwd])
def _sampler_bwd_formula(value_shape, spatial_shapes, loc_shape, weights_shape, dout_shape,
                         *args, out_shape=None, **kwargs) -> int:
    return sampler_bwd_flops(dout_shape, loc_shape)


def op_class(name: str) -> str:
    """The class an operator's FLOPs are reported in."""
    if name in ATTENTION_OPS:
        return "attention"
    if name in SAMPLER_OPS:
        return "deformable_sampling"
    if name in GEMM_OPS:
        return "gemm"
    if name in CONV_OPS:
        return "convolution"
    return "other"


def stage_of(path: str) -> str:
    """The first two named (not numbered) levels of a module path below the
    model: "LWDETR.backbone.0.encoder.blocks.3.attn" -> "backbone/encoder"."""
    parts = [p for p in path.split(".")[1:] if p and not p.isdigit()]
    return "/".join(parts[:2]) if parts else "<model>"


def count_parameters(model: torch.nn.Module) -> int:
    """The model's parameters: what training updates (the JAX `params`)."""
    return sum(p.numel() for p in model.parameters())


def detailed_flops(fn: Callable[[], object], root: str) -> Dict[str, object]:
    """FLOPs of one call of `fn` by operator, class and stage: {"flops_by_op",
    "flops_by_class", "flops_by_stage" ({stage: {class: flops}}), "total"}.
    `root` is the model's class name, the first level of FlopCounterMode's
    module paths. The stages sum to the total; a module called from outside
    its parent (the per-group class heads, which the model calls on the
    two-stage proposals) counts in its own stage, and its parent's and
    caller's own rows carry the difference (one negative, one positive). What
    ran outside the model is the stage OUTSIDE."""
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    counts = mode.get_flop_counts()
    by_op = {str(op).split(".")[-1]: int(n) for op, n in counts.get("Global", {}).items()}
    by_class: Dict[str, int] = defaultdict(int)
    for name, n in by_op.items():
        by_class[op_class(name)] += n
    # FlopCounterMode counts an operator in every module on the stack when it
    # ran (a container that runs no forward of its own has no entry): a
    # module's own FLOPs are its count less its nearest counted descendants'
    paths = [p for p in counts if p == root or p.startswith(root + ".")]
    parent = {p: max((q for q in paths if p.startswith(q + ".")), key=len, default=None)
              for p in paths}
    by_stage: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for op, n in counts.get("Global", {}).items():  # what ran outside the model's forward
        outside = int(n) - int(counts.get(root, {}).get(op, 0))
        if outside:
            by_stage[OUTSIDE][op_class(str(op).split(".")[-1])] += outside
    for path in paths:
        children = [q for q in paths if parent[q] == path]
        for op, n in counts[path].items():
            own = int(n) - sum(int(counts[q].get(op, 0)) for q in children)
            if own:
                by_stage[stage_of(path)][op_class(str(op).split(".")[-1])] += own
    return {"flops_by_op": by_op, "flops_by_class": dict(by_class),
            "flops_by_stage": {k: dict(v) for k, v in by_stage.items()},
            "total": int(sum(by_op.values()))}


def train_step_flops(step: Callable[[], object], forward: Callable[[], object],
                     root: str = "LWDETR") -> Dict[str, object]:
    """FLOPs of one whole train step, `step()` (train-mode forward of every
    query group, criterion and matcher, backward, clipping, optimizer, EMA),
    by operator and class as `detailed_flops` gives them. Stages: the forward's,
    `forward/<stage>`, from `forward()` (the same step's forward and criterion,
    with no backward) counted alone, and `backward`, the rest of the step by
    class (the backward; clipping, the optimizer and the EMA run no counted
    operator). FlopCounterMode's module tracking does not hold in a backward
    (a module some of whose inputs need no gradient is never left, and every
    later backward operator is counted in it too), so the backward is not
    split by module. The stages sum to the total."""
    fwd = detailed_flops(forward, root)
    full = detailed_flops(step, root)
    stages = {f"forward/{k}": dict(v) for k, v in fwd["flops_by_stage"].items()}
    classes = set(full["flops_by_class"]) | set(fwd["flops_by_class"])
    stages["backward"] = {c: full["flops_by_class"].get(c, 0) - fwd["flops_by_class"].get(c, 0)
                          for c in classes}
    return dict(full, flops_by_stage=stages, forward_total=fwd["total"])


def measure_latency(fn: Callable[[], object], device: torch.device, warmup: int = 5,
                    iters: int = 20) -> Dict[str, float]:
    """Median, mean and p95 ms of `fn()`: CUDA events around each call on the
    card, the host clock around each call on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    t = np.asarray(times)
    return {"median_ms": float(np.median(t)), "mean_ms": float(t.mean()),
            "p95_ms": float(np.percentile(t, 95))}


def format_report(report: Dict[str, object], top: int = 12) -> str:
    """The FLOP report as text: GFLOPs by class, then by stage."""
    out = [f"  total {report['total'] / 1e9:.3f} GFLOP"]
    for cls, f in sorted(report["flops_by_class"].items(), key=lambda kv: -kv[1]):
        out.append(f"  {cls:<20} {f / 1e9:10.3f} GFLOP")
    stages = sorted(report["flops_by_stage"].items(), key=lambda kv: -sum(kv[1].values()))
    for stage, by_cls in stages[:top]:
        detail = ", ".join(f"{c} {f / 1e9:.3f}" for c, f in sorted(by_cls.items()))
        out.append(f"    {stage:<32} {sum(by_cls.values()) / 1e9:8.3f} GFLOP ({detail})")
    if len(stages) > top:
        rest = sum(sum(v.values()) for _, v in stages[top:])
        out.append(f"    {'(other stages)':<32} {rest / 1e9:8.3f} GFLOP")
    return "\n".join(out)


@torch.no_grad()
def benchmark_model(model: torch.nn.Module, image_size: int = 640, batch: int = 1,
                    logger=print) -> Dict[str, object]:
    """Startup self-benchmark of `model` on its device in its compute dtype:
    the parameter count, the FLOPs of one eval forward at `image_size` and
    `batch` (by class and stage), and its latency (the reference's
    util/benchmark.py:586-629 run at main.py:263-268). The model is put in
    eval mode for it and back in its mode after. Returns the numbers."""
    device = next(model.parameters()).device
    was_training = model.training
    grads = [p.requires_grad for p in model.parameters()]
    images = torch.zeros((batch, image_size, image_size, 3), device=device)
    # frozen for the bench: FlopCounterMode's module tracker hooks the autograd
    # graph of any input that requires grad, and there is none under no_grad
    model.eval().requires_grad_(False)
    try:
        report = detailed_flops(lambda: model(images), type(model).__name__)
        lat = measure_latency(lambda: model(images)["pred_boxes"], device)
    finally:
        model.train(was_training)
        for p, g in zip(model.parameters(), grads):
            p.requires_grad_(g)
    n_params = count_parameters(model)
    stats = {"n_parameters": n_params, "gflops": report["total"] / 1e9 / batch,
             "gflops_by_class": {k: v / 1e9 / batch for k, v in report["flops_by_class"].items()},
             "fps": 1000.0 / lat["median_ms"] * batch, "batch": batch,
             "image_size": image_size, "dtype": str(getattr(model, "compute_dtype", "")),
             "detailed_flops": report, **lat}
    logger(f"benchmark: {n_params / 1e6:.2f}M params, {stats['gflops']:.2f} GFLOPs/img, "
           f"{stats['fps']:.1f} img/s (median {lat['median_ms']:.2f} ms, mean "
           f"{lat['mean_ms']:.2f}, p95 {lat['p95_ms']:.2f} @ batch {batch}, {image_size}px, "
           f"{stats['dtype']}, {device})")
    logger(format_report(report))
    return stats
