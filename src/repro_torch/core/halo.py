"""Multi-hop halo exchange for time-sharded SPMD execution (paper §6.2);
port of ``repro.core.halo``.

When the timeline is sharded across ranks, every shard holds only its
*core* ticks of each input; the lookback/lookahead halo lives on its
neighbours.  One hop moves data one neighbour over, so the halo is
assembled by a *chain* of hops: hop ``k`` forwards the slab that
originated ``k`` neighbours away, so after ``K = ceil(halo / core)`` hops
every shard has its full halo, whatever the window depth.

The chain is a *static planning artifact*: :func:`schedule` turns one
per-input halo contract (``plan.InputSpec``) into a :class:`HaloSchedule`
— per side, the tick count each hop contributes.  Hops ``1..K-1`` forward
the full core slab; the final hop is trimmed to the remainder before it is
sent, so no hop moves more ticks than the halo still needs.

Each hop is one ``torch.distributed.batch_isend_irecv`` on the axis's
group (:meth:`repro_torch.launch.mesh.AxisComm.hop`): send to ``rank±1``,
receive from ``rank∓1``.  Edge shards (no neighbour ``k`` hops over)
receive zeros and a ``False`` validity mask — the φ encoding of "before
the stream start" / "past the stream end".  Hops whose source would lie
beyond the axis on *every* shard (``k > n-1``) are not sent at all; the
slab is filled with φ locally.

Exchange invariant (what :func:`exchange` returns on every shard)::

    [ left_halo ticks | core ticks | right_halo ticks ]

with time on the last axis and the left halo ordered oldest-first —
identical, tick for tick, to the window :func:`repro_torch.core.parallel.
partition_run` slices out of the global grids for the same partition,
which is why the sharded and host-loop executions agree bit for bit on
identical partitionings.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["HaloSchedule", "HopReport", "schedule", "hop_count", "exchange",
           "exchange_cost"]


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


@dataclasses.dataclass(frozen=True)
class HopReport:
    """Hop geometry of one input for a given shard count (informational;
    see :func:`repro_torch.core.parallel.check_single_hop_halo`)."""

    left_hops: int
    right_hops: int
    min_single_hop_out_len: int  # smallest per-shard out_len with 1 hop max

    @property
    def max_hops(self) -> int:
        return max(self.left_hops, self.right_hops)


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


def exchange_cost(sched: HaloSchedule, n: int) -> dict:
    """Static cost of one :func:`exchange` on an ``n``-shard axis:
    ``{"hops", "ticks"}`` — hops issued and ticks moved *per shard* (every
    shard sends/receives the same slabs).  Pure planning arithmetic,
    mirroring :func:`_pull`: hops beyond ``n - 1`` have no possible source
    shard and are filled with φ locally (no traffic), and every live hop
    forwards the current buffer — the full core slab until the final
    hop's pre-send trim."""
    hops = ticks = 0
    for side in (sched.left_hops, sched.right_hops):
        live = 0 if n <= 1 else min(len(side), n - 1)
        hops += live
        ticks += sum(side[:live])
    return {"hops": hops, "ticks": ticks}


def _phi(value, valid, take: int):
    """A φ slab of ``take`` ticks (zero values, all-False validity)."""
    leaves, spec = tree_flatten(value)
    zv = [torch.zeros(x.shape[:-1] + (take,), dtype=x.dtype,
                      device=x.device) for x in leaves]
    return (tree_unflatten(zv, spec),
            torch.zeros(valid.shape[:-1] + (take,), dtype=torch.bool,
                        device=valid.device))


def _pull(hops: Tuple[int, ...], value, valid, comm, left: bool):
    """Chained hops for one side.

    Returns ``[(v, m), ...]`` with entry ``k-1`` holding the contribution
    of hop ``k`` (the slab that originated ``k`` neighbours away on the
    ``left``/right).  The buffer is forwarded again each hop, so hop ``k``
    moves at most ``core`` ticks; the final hop's buffer is trimmed to the
    remainder *before* it is sent.  Hops with no possible source shard
    (``k > n-1``) are filled with φ locally, with no traffic.
    """
    if not hops:
        return []
    live = min(len(hops), comm.n - 1)
    parts = []
    leaves, spec = tree_flatten(value)
    buf = leaves + [valid]
    for k, take in enumerate(hops, start=1):
        if k > live:
            parts.append(_phi(value, valid, take))
            continue
        if k == len(hops) and take != buf[-1].shape[-1]:
            buf = [x[..., -take:] if left else x[..., :take] for x in buf]
        buf = comm.hop(buf, left)
        parts.append((tree_unflatten(buf[:-1], spec), buf[-1]))
    return parts


def exchange(sched: HaloSchedule, value, valid, comm):
    """Assemble one input's full ``left_halo + core + right_halo`` grid on
    every shard from core-only slabs.

    ``value``/``valid`` are the local core slab (time on the last axis);
    ``comm`` is the :class:`repro_torch.launch.mesh.AxisComm` of the axis
    the timeline is sharded over.  Every rank must call it with the same
    schedule (its hops are collective).  Returns the ``(value, valid)``
    pair the compiled partition body expects — bit-identical to the
    host-loop window of the same partition.
    """
    lparts = _pull(sched.left_hops, value, valid, comm, left=True)
    rparts = _pull(sched.right_hops, value, valid, comm, left=False)
    # hop k is k neighbours away: the left halo reads oldest-first, so the
    # furthest hop comes first; the right halo reads nearest-first.
    segs = list(reversed(lparts)) + [(value, valid)] + rparts
    if len(segs) == 1:
        return value, valid
    vleaves = [tree_flatten(s[0])[0] for s in segs]
    spec = tree_flatten(value)[1]
    fv = tree_unflatten([torch.cat(xs, dim=-1) for xs in zip(*vleaves)],
                        spec)
    fm = torch.cat([s[1] for s in segs], dim=-1)
    return fv, fm
