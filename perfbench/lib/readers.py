"""What the per-layer metric files read: a run's spans, counts and trace.

Each `perfbench/metrics/<name>.py` is a `read(ctx)` that calls one of these;
a reader that finds nothing to read returns None, and the metric is left
out of the result line.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from perfbench.lib import trace as tr
from perfbench.lib import yardstick as ys


@dataclass
class Context:
    """One run as the readers see it."""

    mode: str  # "infer" or "train"
    config: dict  # the configuration file
    traffic: dict
    window: dict  # window_s, batches, images, sizes (one a step done in the window)
    spans: Dict[str, List[float]] = field(default_factory=dict)  # s a call, in the window
    trace: Optional[tr.Trace] = None  # the traced steps
    traced_sizes: List[int] = field(default_factory=list)  # one a traced step
    # distinct positions the sampler's corners read, one a decoder layer of
    # each traced step in turn (`trace.SamplerPoints`)
    sampler_positions: Optional[List[int]] = None

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    @property
    def dtype(self) -> str:
        return self.traffic["dtype"]


def mean_span_ms(ctx: Context, name: str, mode: str) -> Optional[float]:
    """Host ms a call of the span `name` in the window."""
    calls = ctx.spans.get(name) or []
    if ctx.mode != mode or not calls:
        return None
    return 1e3 * sum(calls) / len(calls)


def span_ms_per_step(ctx: Context, name: str, mode: str) -> Optional[float]:
    """Host ms a step inside the span `name` in the window."""
    calls = ctx.spans.get(name) or []
    steps = ctx.window.get("batches", 0)
    if ctx.mode != mode or not calls or not steps:
        return None
    return 1e3 * sum(calls) / steps


def stage_ms(ctx: Context, stages, mode: str) -> Optional[float]:
    """Device ms a traced step in the given stages."""
    if ctx.mode != mode or ctx.trace is None or not ctx.traced_sizes:
        return None
    names = {n for n, _ in tr.STAGES} | {tr.POST_PROCESS, tr.CRITERION, tr.BACKWARD,
                                         tr.OPTIMIZER}
    times = tr.stage_times(ctx.trace, names)
    us = sum(times.get(s, 0.0) for s in stages)
    return us / 1e3 / len(ctx.traced_sizes) if us > 0 else None


def roofline(ctx: Context, groups, least_fn, mode: str) -> Optional[float]:
    """% of the least time (from the shapes) over the device time the
    groups' kernels took, over the traced steps."""
    if ctx.mode != mode or ctx.trace is None or not ctx.traced_sizes:
        return None
    least = ys.total_least(least_fn, ctx.config["model"], ctx.traced_sizes, ctx.batch,
                           mode == "train", ctx.dtype)
    return share(ctx, groups, least)


def sampler_roofline(ctx: Context, mode: str) -> Optional[float]:
    """`roofline` of the deformable sampling, whose bytes count the
    positions the traced steps' own points read."""
    if ctx.mode != mode or ctx.trace is None or not ctx.traced_sizes \
            or not ctx.sampler_positions:
        return None
    least = ys.sampler_total_least(ctx.config["model"], ctx.traced_sizes, ctx.batch,
                                   mode == "train", ctx.dtype, ctx.sampler_positions)
    return None if least is None else share(ctx, tr.SAMPLER_GROUPS, least)


def share(ctx: Context, groups, least: float) -> Optional[float]:
    """% of `least` seconds over the device time the groups' kernels took."""
    device_us = sum(v for k, v in tr.group_times(ctx.trace).items() if k in groups)
    if device_us <= 0:
        return None
    return 100.0 * least / (device_us / 1e6)


def mfu(ctx: Context, mode: str) -> Optional[float]:
    """% of the dense bf16 peak: the reference's FLOPs of every step done in
    the window over the window's seconds."""
    w = ctx.window
    if ctx.mode != mode or not w.get("sizes") or w.get("window_s", 0) <= 0:
        return None
    flops = sum(ys.step_flops(ctx.config, mode, s, ctx.batch) for s in w["sizes"])
    return 100.0 * flops / w["window_s"] / ys.MFU_PEAK


def idle_share(ctx: Context, mode: str) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if ctx.mode != mode or ctx.trace is None:
        return None
    a, b = ctx.trace.window
    busy = tr.busy_us(ctx.trace)
    if b <= a or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (b - a))
