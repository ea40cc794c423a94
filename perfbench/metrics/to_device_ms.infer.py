"""Host ms a batch in `data/loader.py::to_device`: pinning and the copy's enqueue."""
from perfbench.lib.readers import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "to_device", "infer")
