"""``seg_dirty``'s share of its bytes roofline in the traced stretch."""
from tiltbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "seg_dirty", "seg_dirty")
