"""Host ms a step inside `criterion.hungarian_match`: costs built, M1 enqueued."""
from perfbench.lib.readers import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "matcher", "train")
