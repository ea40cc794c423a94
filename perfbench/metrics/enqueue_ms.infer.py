"""Host ms a batch inside the program's step call: dispatch and launches, before any wait."""
from perfbench.lib.readers import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "enqueue", "infer")
