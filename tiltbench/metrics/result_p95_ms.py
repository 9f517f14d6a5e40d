"""95th percentile of every chunk's result latency in the window (open
loop: from when the chunk's last tick was due to when its result is
complete)."""
from tiltbench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 95)
