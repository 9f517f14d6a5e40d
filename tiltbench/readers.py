"""Arithmetic the metric readers in ``metrics/`` share.  Each returns
``None`` where the run gave it nothing to read."""
from __future__ import annotations

from typing import Optional

from . import roofline
from .harness import Ctx, percentile

__all__ = ["latency_ms", "step_host_ms", "kernel_roofline", "idle_pct"]


def latency_ms(ctx: Ctx, q: float) -> Optional[float]:
    """The ``q``-th percentile of every chunk's result latency."""
    if not ctx.latencies_s:
        return None
    return percentile(ctx.latencies_s, q) * 1e3


def step_host_ms(ctx: Ctx) -> Optional[float]:
    """Host time inside ``Runner.step`` a chunk, over the whole window."""
    if ctx.chunks == 0:
        return None
    return ctx.step_host_s / ctx.chunks * 1e3


def kernel_roofline(ctx: Ctx, wrapper: str, device_prefix: str
                    ) -> Optional[float]:
    """A kernel's share of its bytes roofline over the traced stretch: the
    bytes its launches needed (shapes recorded at ``wrapper``) at
    3.35 TB/s, over the device time of the kernels whose name starts with
    ``device_prefix``."""
    if ctx.trace is None:
        return None
    nbytes = ctx.stretch_bytes(wrapper)
    secs = sum(v[0] for k, v in ctx.trace["kernels"].items()
               if k.startswith(device_prefix))
    if not nbytes or secs <= 0:
        return None
    return roofline.share_pct(nbytes, secs)


def idle_pct(ctx: Ctx) -> Optional[float]:
    """Share of the traced stretch with nothing running on the card."""
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
