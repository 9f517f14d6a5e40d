"""Median of every chunk's result latency in the window (open loop)."""
from tiltbench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 50)
