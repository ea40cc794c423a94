"""Readers of the program's own spans (`lwdetr_tpu_torch/utils/trace.py`).

While the program's recorder is on (`trace.enable()`) it keeps host totals
a span (`trace.snapshot()`: {span: {"calls", "ns", "per_call_ns"}}) and,
under the profiler, opens a range "lwdetr:<span>" on the kernels' timeline,
which `trace.from_profiler` keeps among a `Trace`'s ranges as it keeps every
user range. The readers take a run's `readers.Context`, and the recorder's
snapshot of the window where they read host time; each returns None where
it finds nothing to read (a program without the spans, a run in which the
recorder stayed off), as the metric readers do. The harness does not turn
the recorder on yet: `perfbench/spans.py` drives a cell with it on.

* `host_ms_per_step`: host ms a step (a batch) of the window inside a span:
  "fetch" (the eval loop's wait for a batch's detections), "metric fetch"
  (the train loop's one-step-late fetch), the step's phases "forward",
  "criterion", "backward", "optimizer";
* `unspanned_idle_share`: % of the traced window in which the device ran
  nothing and no program span was open on the host (by time, on any thread);
* `idle_gaps`: the device's longest idle stretches, each named by the
  innermost program span open on the host when it began.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from perfbench.lib import trace as tr
from perfbench.lib.readers import Context

PREFIX = "lwdetr:"  # the program's range prefix, as of this copy
NO_SPAN = "no program span"


def host_ms_per_step(ctx: Context, snap: Optional[Dict[str, dict]], name: str,
                     mode: str) -> Optional[float]:
    """Host ms a step (a batch) of the window inside the program's span `name`."""
    entry = (snap or {}).get(name)
    steps = ctx.window.get("batches", 0)
    if ctx.mode != mode or not entry or not entry.get("calls") or not steps:
        return None
    return entry["ns"] / 1e6 / steps


def program_ranges(trace: tr.Trace) -> List[tr.Interval]:
    """The program's span ranges of a trace, their names without the prefix."""
    return [(s, e, name[len(PREFIX):]) for s, e, name in trace.ranges
            if name.startswith(PREFIX)]


def unspanned_idle_share(ctx: Context, mode: str) -> Optional[float]:
    """% of the traced window in which no operation ran on the device and no
    program span was open on the host."""
    if ctx.mode != mode or ctx.trace is None:
        return None
    spans = program_ranges(ctx.trace)
    a, b = ctx.trace.window
    if not spans or b <= a or tr.busy_us(ctx.trace) <= 0:
        return None
    # the spans' stretches as if the device ran them: the union's complement
    covered = tr.Trace(device=ctx.trace.device + spans, ranges=[(a, b, tr.WINDOW)])
    return 100.0 * (1.0 - tr.busy_us(covered) / (b - a))


def idle_gaps(trace: tr.Trace, top: int = 10) -> List[Tuple[str, float]]:
    """The longest idle stretches of the device in the window (us), each
    named by the innermost program span open on the host when it began."""
    named = tr.Trace(device=trace.device,
                     ranges=[(*trace.window, tr.WINDOW)]
                     + [(s, e, tr.SPAN + n) for s, e, n in program_ranges(trace)])
    return [(NO_SPAN if n == "no span" else n, us) for n, us in tr.idle_gaps(named, top)]
