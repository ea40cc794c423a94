"""CUDA graphs of whole steps: the train chain and the batch-1 eval forward.

The JAX package times a step with no dispatch in it by running several steps
inside one jit (`bench_train.py --chain`, `scripts/bench_all.py`'s K-deep
forward). Here a step is captured once as a CUDA graph and replayed: a replay
launches every kernel of the step with no Python, wrapper or host check
between them. A graph replays exactly what it captured, so a step is fit for
it only when it reads nothing from the host that changes between replays
(`train.optim.capturable_adamw` and `DeviceStepLR` move the optimizer's lr
and step count to the card; `models.drop.draw` fills its scalar there) and
syncs with the host nowhere.

`capture` warms a call up and captures it. `GuardedGraph` is a captured
no-grad forward that refuses to replay once a parameter changed: under
`torch.no_grad` the model's bf16 weight casts are cached on a host key (each
parameter's storage and `_version`, `models/cast.py`), which a replay never
looks at, so after an optimizer step, an EMA update or a `load_state_dict` the
graph would replay the casts of the old weights.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence

import torch


def capture(fn: Callable[[], Any], warmup: int = 2,
            generators: Iterable[torch.Generator] = (),
            reset: Optional[Callable[[], None]] = None):
    """(graph, out): `fn()` run `warmup` times on a side stream (kernel builds,
    lazily made state, cuBLAS workspaces), then `reset()` if given (to undo
    what the warm-up calls changed), then `fn()` captured once on that stream;
    `out` is what the captured call returned, tensors that every replay
    rewrites. Each generator of `generators` is registered with the graph
    before the capture, so a replay draws from its next offsets. A capture that
    fails raises; nothing runs the step another way."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
        if reset is not None:
            reset()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    return graph, out


class GuardedGraph:
    """`fn()` (a forward under `torch.no_grad`) captured by `capture`, replayed
    by `replay()` only while every tensor of `guarded` (the model's
    parameters) has the storage and `_version` it had at the capture; after a
    change `replay()` raises, and a new graph must be captured."""

    def __init__(self, fn: Callable[[], Any], guarded: Sequence[torch.Tensor], warmup: int = 2):
        self.guarded = list(guarded)
        self.graph, self.out = capture(fn, warmup)
        self.stamp = self._stamp()

    def _stamp(self):
        return [(t.data_ptr(), t._version) for t in self.guarded]

    def replay(self):
        """One replay on the current stream; returns the graph's outputs."""
        if self._stamp() != self.stamp:
            moved = [i for i, (a, b) in enumerate(zip(self._stamp(), self.stamp)) if a != b]
            raise RuntimeError(f"{len(moved)} guarded tensors changed since the capture (the "
                               f"first is number {moved[0]}): the graph would replay the cached "
                               "casts of the old weights; capture it again")
        self.graph.replay()
        return self.out
