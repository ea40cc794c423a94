"""% of the attention's least time (from the shapes) over the device time of K1, K2, K9, K6, K7."""
from perfbench.lib.readers import roofline
from perfbench.lib.trace import ATTENTION_GROUPS
from perfbench.lib.yardstick import attention_least_s


def read(ctx):
    return roofline(ctx, ATTENTION_GROUPS, attention_least_s, "train")
