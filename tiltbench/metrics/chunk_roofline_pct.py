"""The whole chunk's share of the bytes roofline: what one chunk's
semantics need (the inputs the query reads, the output grid, the carried
tails read and written) at 3.35 TB/s, over the window's wall time a
chunk."""
from tiltbench import roofline


def read(ctx):
    if ctx.loop != "closed" or not ctx.chunks:
        return None
    return roofline.share_pct(ctx.chunk_bytes, ctx.window_s / ctx.chunks)
