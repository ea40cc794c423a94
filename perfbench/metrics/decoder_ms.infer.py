"""Device ms a traced step in the projector, two-stage proposals, decoder and heads."""
from perfbench.lib.readers import stage_ms
from perfbench.lib.trace import DECODER_STAGES


def read(ctx):
    return stage_ms(ctx, DECODER_STAGES, "infer")
