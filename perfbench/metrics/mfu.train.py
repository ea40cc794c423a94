"""% of the dense bf16 peak: the reference's FLOPs of the window's steps over its seconds."""
from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
