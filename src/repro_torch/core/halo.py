"""Multi-hop halo planning (port of the planning half of
``repro.core.halo``).

When the timeline is sharded across devices, each shard's lookback and
lookahead halo lives on its neighbours and arrives through a chain of
``ceil(halo / core)`` hops per side.  :func:`schedule` turns one per-input
halo contract (``plan.InputSpec``) into that static :class:`HaloSchedule`.
The exchange itself belongs to the multi-device path, which this package
does not have yet; the planning arithmetic is here because
``InputSpec.halo_schedule`` exposes it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

__all__ = ["HaloSchedule", "schedule", "hop_count"]


def hop_count(halo: int, core: int) -> int:
    """Number of ppermute hops needed to pull ``halo`` ticks when each
    shard holds ``core`` ticks: ``ceil(halo / core)`` (0 for no halo)."""
    if halo <= 0:
        return 0
    if core <= 0:
        raise ValueError(f"per-shard core must be positive, got {core}")
    return -(-halo // core)


@dataclasses.dataclass(frozen=True)
class HaloSchedule:
    """Static per-input hop schedule (a planning artifact, like the halo
    contract it derives from).

    ``left_hops`` / ``right_hops`` hold the tick count contributed by hop
    ``k`` (1-indexed: hop ``k`` delivers the slab that originated ``k``
    neighbours away).  Every hop but the last contributes the full core
    slab; the last contributes the remainder, so ``sum(left_hops) ==
    left_halo`` and likewise on the right.
    """

    core: int
    left_hops: Tuple[int, ...]
    right_hops: Tuple[int, ...]

    @property
    def left_halo(self) -> int:
        return sum(self.left_hops)

    @property
    def right_halo(self) -> int:
        return sum(self.right_hops)

    @property
    def max_hops(self) -> int:
        return max(len(self.left_hops), len(self.right_hops))


def _hops(halo: int, core: int) -> Tuple[int, ...]:
    k = hop_count(halo, core)
    if k == 0:
        return ()
    return (core,) * (k - 1) + (halo - (k - 1) * core,)


@functools.lru_cache(maxsize=None)
def schedule(left_halo: int, right_halo: int, core: int) -> HaloSchedule:
    """The hop schedule serving a ``(left_halo, right_halo, core)`` halo
    contract.  Cached — schedules are tiny and shared across executors."""
    return HaloSchedule(core=core, left_hops=_hops(left_halo, core),
                        right_hops=_hops(right_halo, core))
