"""``sliding_assoc``'s share of its bytes roofline in the traced stretch
(its device kernels are named ``sliding_*``)."""
from tiltbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "sliding_assoc", "sliding_")
