"""The port's host spans: its loops, the train step's phases and the model's
stages, each timed where it runs.

    with trace.span("fetch"):
        dets = _fetch(tensors)
    x = trace.call("patch embed", self.patch_embed, x)  # fn(*args) inside a span

Recording is off unless `enable()` is called. While it is off, `span` reads
one module flag and returns a shared `contextlib.nullcontext`: no clock
reading, no allocation, no profiler call. While recording is on, each span adds its host
nanoseconds (`time.perf_counter_ns`) and one call to its name's totals
(`snapshot()`); the spans of `PER_CALL`, one a batch or a step, keep each
call's duration too. While a `torch.profiler` records as well, each span
opens the range "lwdetr:<name>" (`record_function`), which the profiler
places on the kernels' timeline: the kernels a span's host code launched fall
inside its range, and a stretch in which the device ran nothing is named by
the innermost span open on the host then. Spans nest; each counts its whole
stretch, inner spans included.

`call(name, fn, *args)` brackets a call as a module's forward hooks would:
its arguments are computed before the span opens. The stage spans are opened
so around the model's modules (`STAGES`). The train step's body runs its
spans on the host once, at capture, when the step is captured as a CUDA graph
(`train/engine.py::build_train_chain`).
"""
from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict

import torch

PREFIX = "lwdetr:"  # the profiler ranges' names: PREFIX + span name
# the loops' spans (`train/engine.py`, `data/loader.py::to_device`), one a batch or step
LOOP = ("loader", "to_device", "step", "fetch", "evaluator", "metric fetch")
# the train step body's phases (`train/engine.py::_step_body`), one a step
PHASES = ("forward", "criterion", "backward", "optimizer")
PER_CALL = frozenset(LOOP + PHASES)  # the spans that keep each call's duration
# the model's stages, in the order a forward opens them
STAGES = ("patch embed", "window blocks", "global blocks", "projector", "proposals",
          "decoder self-attention", "decoder cross-attention", "decoder FFN", "decoder norms",
          "heads")

_on = False
_OFF = contextlib.nullcontext()
# name -> [calls, ns, [ns a call] or None]; unlocked: the threads that open
# spans (the loop's, autograd's in a backward) do not run them at once
_totals: Dict[str, list] = {}


class _Span:
    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        total = _totals.get(self.name)
        if total is None:
            total = _totals[self.name] = [0, 0, [] if self.name in PER_CALL else None]
        total[0] += 1
        total[1] += ns
        if total[2] is not None:
            total[2].append(ns)
        return False


def span(name: str):
    """A context manager timing the stretch it encloses under `name` while
    recording is on; the shared no-op otherwise."""
    if not _on:
        return _OFF
    return _Span(name)


def call(name: str, fn: Callable, *args, **kwargs):
    """fn(*args, **kwargs) inside the span `name`."""
    with span(name):
        return fn(*args, **kwargs)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """A decorator: each call of the function inside the span `name`."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return call(name, fn, *args, **kwargs)
        return inner
    return wrap


def enable() -> None:
    """Turn recording on (the totals already recorded stay)."""
    global _on
    _on = True


def disable() -> None:
    """Turn recording off: spans return the no-op from here on."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget the totals recorded so far."""
    _totals.clear()


def snapshot() -> Dict[str, dict]:
    """{name: {"calls", "ns", "per_call_ns"}} of the spans recorded since the
    last `reset()`; `per_call_ns` lists each call's ns for the spans of
    `PER_CALL` and is empty for the others."""
    return {name: {"calls": calls, "ns": ns, "per_call_ns": list(each or ())}
            for name, (calls, ns, each) in list(_totals.items())}


@contextlib.contextmanager
def recording():
    """Totals reset, then recording on while the block runs, and off after it."""
    reset()
    enable()
    try:
        yield
    finally:
        disable()


def mean_ms(snap: Dict[str, dict], name: str):
    """Host ms a call of the span `name` in `snap`, or None if it never ran."""
    entry = snap.get(name)
    return entry["ns"] / 1e6 / entry["calls"] if entry else None
