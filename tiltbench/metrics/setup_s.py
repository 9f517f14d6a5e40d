"""Process start to the first timed chunk: the kernel build (first run in
a checkout), the data made on the card, planning, the capture of every
step and the warm-up chunks."""


def read(ctx):
    return ctx.setup_s
