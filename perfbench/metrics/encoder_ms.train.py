"""Device ms a traced step in the encoder: patch embed, window and global blocks."""
from perfbench.lib.readers import stage_ms
from perfbench.lib.trace import ENCODER_STAGES


def read(ctx):
    return stage_ms(ctx, ENCODER_STAGES, "train")
