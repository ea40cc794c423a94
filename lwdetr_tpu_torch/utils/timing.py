"""Device timing with CUDA events.

`measure_ms` runs `fn` a few times to warm up (kernel builds, allocator,
cuDNN plans), then times `repeats` samples of `iters` back-to-back calls
between two CUDA events on the current stream, and synchronizes. PyTorch
returns before the device finishes, so a host clock without a synchronize
would time the enqueue; the events time the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch


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
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    ordered = sorted(samples)
    return {"ms": ordered[len(ordered) // 2], "ms_mean": sum(samples) / repeats,
            "ms_min": ordered[0], "ms_max": ordered[-1], "samples": samples}
