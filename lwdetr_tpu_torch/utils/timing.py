"""Device timing with CUDA events.

`measure_ms` runs `fn` a few times to warm up (kernel builds, allocator,
cuDNN plans), then times `repeats` samples of `iters` back-to-back calls
between two CUDA events on the current stream, and synchronizes. PyTorch
returns before the device finishes, so a host clock without a synchronize
would time the enqueue; the events time the device. A call whose host work
(Python, the wrapper, the launch) takes longer than its kernels is timed at
the host's pace: `measure_graph_ms` captures `iters` calls in one CUDA graph
and times its replays, which leaves only the device's time.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch


def _summary(samples) -> Dict[str, Any]:
    ordered = sorted(samples)
    return {"ms": ordered[len(ordered) // 2], "ms_mean": sum(samples) / len(samples),
            "ms_min": ordered[0], "ms_max": ordered[-1], "samples": samples}


def _timed(run: Callable[[], Any], repeats: int, per: int):
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per)
    return samples


def measure_ms(fn: Callable[..., Any], *args: Any, iters: int = 20, warmup: int = 3,
               repeats: int = 5) -> Dict[str, Any]:
    """Per-call milliseconds of `fn(*args)` on the current CUDA device:
    {"ms": median sample, "ms_mean": all timed time / all timed calls,
    "ms_min": ..., "ms_max": ..., "samples": [...]}."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_ms times the CUDA device and there is none")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn(*args)

    return _summary(_timed(run, repeats, iters))


def measure_graph_ms(fn: Callable[[], Any], iters: int = 20, repeats: int = 5,
                     prepare: Optional[Callable[[], Any]] = None) -> Dict[str, Any]:
    """Per-call device milliseconds of `fn()`: `iters` calls captured in one
    CUDA graph (after a warm-up call outside it), the graph replayed
    `repeats` times between CUDA events; same keys as `measure_ms`.
    `prepare()`, if given, runs first, untimed, on the stream the graph is
    captured on: autograd runs a backward on the stream of its forward, so a
    backward is captured only when `prepare` made its forward there."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_graph_ms times the CUDA device and there is none")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        if prepare is not None:
            prepare()
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _summary(_timed(graph.replay, repeats, iters))
