"""% of the traced window in which the device ran nothing."""
from perfbench.lib.readers import idle_share


def read(ctx):
    return idle_share(ctx, "infer")
