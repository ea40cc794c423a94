"""Device ms a traced step from the criterion's return to the gradient clipping."""
from perfbench.lib.readers import stage_ms
from perfbench.lib.trace import BACKWARD


def read(ctx):
    return stage_ms(ctx, (BACKWARD,), "train")
