"""% of the deformable sampling's least time (the positions its points read
counted from the traced steps) over the device time of K3, K4, K10, K5, K8, K10b."""
from perfbench.lib.readers import sampler_roofline


def read(ctx):
    return sampler_roofline(ctx, "train")
