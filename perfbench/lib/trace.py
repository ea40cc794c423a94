"""From a profiler trace and host spans to the per-layer numbers.

The arithmetic is a frozen copy of the program's `breakdown.py` (its
`GROUPS`, `STAGES` and `stage_times`) and of its idle share, kept here so
that a change to the program cannot move the yardstick. A trace is reduced
first to plain tuples (`Trace`): the readers and their tests see nothing of
the profiler.

* `launches`: (host time of the launch, [(kernel name, device us), ...]),
  one entry a host call that launched kernels;
* `device`: (start, end, name) of every operation on the device's timeline
  (kernels, copies, fills), in the host's clock, as the profiler aligns them;
* `ranges`: (start, end, name) of the host ranges: the model's stages, the
  benchmark's spans ("span:<name>") and the traced window ("window").
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple
from unittest import mock

import torch

from perfbench.lib import yardstick as ys

# (group, patterns): a kernel goes to the first group one of whose patterns
# `re.search`es its lower-cased name (breakdown.py's GROUPS as of this copy)
GROUPS = (
    ("K9 window_attention (no bias)", (r"window_attention_bias_kernel<[^(]*false>",
                                       r"window_attention_mma_kernel<[^(]*false>")),
    ("K1 window_attention_bias", ("window_attention_bias_kernel", "window_attention_mma_kernel")),
    ("K2 flash_attention_cm", ("flash_attention_cm_kernel", "flash_attention_cm_mma_kernel")),
    ("K8 deform_attn_cm_bwd", ("deform_attn_cm_bwd_kernel", "position_to_channel_major")),
    ("K3 deform_attn_cm", ("deform_attn_cm_kernel",)),
    ("K10 deform_attn_rowmajor", (r"deform_attn_sep_kernel<[^(]*rowmajorlayout",
                                  r"deform_attn_sep_bf16_kernel<[^(]*rowmajorlayout")),
    ("K10 deform_attn_rowmajor_bwd", (r"deform_attn_sep_bwd_kernel<[^(]*rowmajorlayout",)),
    ("K4 deform_attn_sep", ("deform_attn_sep_kernel", "deform_attn_sep_bf16_kernel")),
    ("K5 deform_attn_sep_bwd", ("deform_attn_sep_bwd_kernel",)),
    ("K6 flash_attention_cm_bwd", ("attention_bwd_dq_kernel", "attention_bwd_dkdv_kernel")),
    ("K7 window_attention_bwd (no bias)", (r"window_attention_bias_bwd_kernel<[^(]*false>",)),
    ("K7 window_attention_bias_bwd", ("window_attention_bias_bwd_kernel",)),
    ("M1 assignment", ("assignment_kernel",)),
    ("optimizer/EMA (foreach)", ("multi_tensor_apply", "lpnorm")),
    ("norm", ("layer_norm", "batch_norm", "bn_", "norm")),
    ("conv", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
    ("topk/sort", ("topk", "sort", "radix", "gather")),
)
OTHER = "other elementwise/copy"
ATTENTION_GROUPS = ("K1 window_attention_bias", "K2 flash_attention_cm",
                    "K9 window_attention (no bias)", "K6 flash_attention_cm_bwd",
                    "K7 window_attention_bias_bwd", "K7 window_attention_bwd (no bias)")
SAMPLER_GROUPS = ("K3 deform_attn_cm", "K4 deform_attn_sep", "K10 deform_attn_rowmajor",
                  "K5 deform_attn_sep_bwd", "K8 deform_attn_cm_bwd",
                  "K10 deform_attn_rowmajor_bwd")

# (stage, module-name pattern; {window}: the window blocks' indexes)
STAGES = (
    ("patch embed", r"backbone\.0\.encoder\.patch_embed"),
    ("encoder window blocks", r"backbone\.0\.encoder\.blocks\.({window})"),
    ("encoder global blocks", r"backbone\.0\.encoder\.blocks\.\d+"),
    ("projector", r"backbone\.0\.projector"),
    ("two-stage proposals", r"transformer\.enc_(output|output_norm|out_class_embed|"
                            r"out_bbox_embed)\.\d+"),
    ("decoder self-attention", r"transformer\.decoder\.layers\.\d+\.self_attn"),
    ("decoder cross-attention", r"transformer\.decoder\.layers\.\d+\.cross_attn"),
    ("decoder FFN", r"transformer\.decoder\.layers\.\d+\.linear[12]"),
    ("decoder norms, reference points", r"transformer\.decoder\.(layers\.\d+\.norm\d|norm|"
                                        r"ref_point_head)"),
    ("heads", r"(class_embed|bbox_embed)"),
)
ENCODER_STAGES = ("patch embed", "encoder window blocks", "encoder global blocks")
DECODER_STAGES = ("projector", "two-stage proposals", "decoder self-attention",
                  "decoder cross-attention", "decoder FFN", "decoder norms, reference points",
                  "heads")
POST_PROCESS, CRITERION, BACKWARD, OPTIMIZER = ("post_process", "criterion + matcher",
                                                "backward", "clip + optimizer + EMA")
UNATTRIBUTED = "unattributed"
WINDOW = "window"
SPAN = "span:"
ANNOTATIONS = ("Optimizer.", "ProfilerStep", "## ")

Interval = Tuple[float, float, str]


@dataclass
class Trace:
    launches: List[Tuple[float, List[Tuple[str, float]]]] = field(default_factory=list)
    device: List[Interval] = field(default_factory=list)
    ranges: List[Interval] = field(default_factory=list)

    @property
    def window(self) -> Tuple[float, float]:
        """The traced window's (start, end): its "window" range."""
        start, end, _ = next(r for r in self.ranges if r[2] == WINDOW)
        return start, end


def group_of(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(re.search(k, low) for k in keys):
            return label
    return OTHER


def group_times(trace: Trace) -> Dict[str, float]:
    """{group: device us} over the kernels launched in the window."""
    a, b = trace.window
    out: Dict[str, float] = defaultdict(float)
    for t, kernels in trace.launches:
        if a <= t <= b:
            for name, dur in kernels:
                out[group_of(name)] += dur
    return dict(out)


def stage_times(trace: Trace, names: Sequence[str]) -> Dict[str, float]:
    """{stage: device us}: each launch's kernels count in the innermost range
    of `names` open when the launch began (by host time, on any thread);
    the rest is UNATTRIBUTED."""
    a, b = trace.window
    ranges = sorted((r for r in trace.ranges if r[2] in names), key=lambda r: r[0])
    out: Dict[str, float] = defaultdict(float)
    active: List[Interval] = []
    nxt = 0
    for t, kernels in sorted(trace.launches, key=lambda lk: lk[0]):
        if not a <= t <= b:
            continue
        while nxt < len(ranges) and ranges[nxt][0] <= t:
            active.append(ranges[nxt])
            nxt += 1
        active = [r for r in active if r[1] >= t]
        best = min(active, key=lambda r: r[1] - r[0]) if active else None
        out[best[2] if best else UNATTRIBUTED] += sum(d for _, d in kernels)
    return dict(out)


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device's operations, clipped to the window."""
    a, b = trace.window
    merged: List[List[float]] = []
    for s, e, _ in sorted(trace.device):
        s, e = max(s, a), min(e, b)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_us(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def idle_gaps(trace: Trace, top: int = 10) -> List[Tuple[str, float]]:
    """The longest idle stretches of the device in the window, each named by
    the innermost benchmark span open on the host when it began ("no span"
    where none was)."""
    a, b = trace.window
    busy = busy_intervals(trace)
    gaps, t = [], a
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if b > t:
        gaps.append((t, b))
    spans = [r for r in trace.ranges if r[2].startswith(SPAN)]
    out = []
    for s, e in gaps:
        inside = [r for r in spans if r[0] <= s <= r[1]]
        label = min(inside, key=lambda r: r[1] - r[0])[2][len(SPAN):] if inside else "no span"
        out.append((label, e - s))
    return sorted(out, key=lambda g: -g[1])[:top]


def from_profiler(prof) -> Trace:
    """A `torch.profiler.profile`'s events as a `Trace` (times in us)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    trace = Trace()
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cpu:
            kernels = getattr(e, "kernels", None)
            if kernels:
                trace.launches.append((start, [(k.name, k.duration) for k in kernels]))
            if getattr(e, "is_user_annotation", False) or e.key.startswith(SPAN) \
                    or e.key == WINDOW or e.key in _RANGE_NAMES:
                trace.ranges.append((start, end, e.key))
        elif e.device_type == cuda and not getattr(e, "is_user_annotation", False) \
                and not e.key.startswith(ANNOTATIONS) and e.key not in _RANGE_NAMES \
                and not e.key.startswith(SPAN) and e.key != WINDOW:
            trace.device.append((start, end, e.key))
    return trace


_RANGE_NAMES = {name for name, _ in STAGES} | {POST_PROCESS, CRITERION, BACKWARD, OPTIMIZER}


class Spans:
    """Host spans of the benchmark's own, around calls into the program:
    `wrap(name, fn)` times each call of fn; `open(name)` / `close()` do the
    same by hand. While `traced` each span is also a profiler range
    ("span:<name>"), so that the device's idle gaps can be named by it."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.traced = False
        self.recording = False
        self._open: List[Tuple[str, float, object]] = []

    def open(self, name: str) -> None:
        rf = None
        if self.traced:
            rf = torch.autograd.profiler.record_function(SPAN + name)
            rf.__enter__()
        self._open.append((name, time.perf_counter(), rf))

    def close(self) -> None:
        name, t0, rf = self._open.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        if self.recording:
            self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, name: str, fn: Callable) -> Callable:
        def call(*args, **kwargs):
            self.open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.close()
        return call


class StageRanges:
    """Forward hooks that open a profiler range around each stage's modules
    while `enabled` (breakdown.py's, frozen here); `open` / `close` for the
    step's other parts."""

    def __init__(self, model):
        window = "|".join(str(i) for i in model.cfg.window_block_indexes) or "x"
        rules = [(name, re.compile(pat.format(window=window))) for name, pat in STAGES]
        self.handles, self.active, self.enabled = [], [], False
        for mname, module in model.named_modules():
            stage = next((name for name, rule in rules if rule.fullmatch(mname)), None)
            if stage is not None:
                self.handles.append(module.register_forward_pre_hook(
                    lambda m, a, stage=stage: self.open(stage)))
                self.handles.append(module.register_forward_hook(lambda m, a, o: self.close()))

    def open(self, name: str) -> None:
        if self.enabled:
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self.active.append(rf)

    def close(self) -> None:
        if self.enabled and self.active:
            self.active.pop().__exit__(None, None, None)

    def ranged(self, name: str, fn: Callable) -> Callable:
        """fn within a range of its own."""
        def call(*args, **kwargs):
            self.open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.close()
        return call

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class SamplerPoints:
    """While entered, the sampling locations of every call into the
    program's deformable samplers (the three entries of `ops/deform_attn.py`
    that the decoder calls), held by reference and not copied, so that no
    device work joins a trace; `positions()` then counts, a call at a time,
    the distinct positions their corners read."""

    ENTRIES = ("ms_deform_attn_cm", "ms_deform_attn_sep_panels", "ms_deform_attn")

    def __init__(self):
        self.calls: List[tuple] = []

    def __enter__(self):
        from lwdetr_tpu_torch.ops import deform_attn as da

        self._patches = [mock.patch.object(da, n, self._noting(getattr(da, n)))
                         for n in self.ENTRIES]
        for p in self._patches:
            p.start()
        return self

    def __exit__(self, *exc) -> None:
        for p in reversed(self._patches):
            p.stop()

    def _noting(self, fn: Callable) -> Callable:
        def call(value, spatial_shapes, loc, *args, **kwargs):
            self.calls.append((loc.detach(), spatial_shapes))
            return fn(value, spatial_shapes, loc, *args, **kwargs)
        return call

    def positions(self) -> List[int]:
        out = [ys.touched_positions(loc, shapes) for loc, shapes in self.calls]
        self.calls.clear()
        return out


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def profiled(device):
    """A profiler over the host and `device`, with a "window" range inside."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        holder = {"prof": prof}
        with torch.autograd.profiler.record_function(WINDOW):
            yield holder
            sync(device)
    holder["trace"] = from_profiler(prof)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The traced window's device time by group and its longest idle gaps, s."""
    groups = sorted(group_times(trace).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e6] for k, v in groups],
            "idle_gaps": [[k, v / 1e6] for k, v in idle_gaps(trace, top)]}
