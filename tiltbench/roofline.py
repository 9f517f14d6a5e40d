"""Byte counts and the card's peak, for the roofline shares.

Every kernel this benchmark prices is bound by bytes: its least time is
its bytes over the memory rate.  A kernel's bytes are each input byte read
once and each output byte written once, for the call at the shapes it was
launched at; a chunk's bytes are what the query's semantics need of one
chunk.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

__all__ = ["HBM_BYTES_PER_S", "sliding_assoc_bytes", "seg_dirty_bytes",
           "chunk_bytes", "share_pct", "over_picks"]

# NVIDIA H100 SXM, published: 80 GB of HBM3 at 3.35 TB/s (at 700 W).
HBM_BYTES_PER_S = 3.35e12


def sliding_assoc_bytes(rows: int, ticks: int, itemsize: int = 4) -> int:
    """``sliding_assoc`` over ``(rows, ticks)``: the input read once and an
    output of the same shape and dtype written once."""
    return 2 * int(rows) * int(ticks) * int(itemsize)


def seg_dirty_bytes(mats: Iterable[Tuple[Tuple[int, ...], int]],
                    n_units: int, n_segs: int) -> int:
    """``seg_dirty`` over row matrices ``[(shape, itemsize), ...]``: each
    matrix read once, and one bool flag a (unit, segment) written once."""
    n = 0
    for shape, itemsize in mats:
        size = 1
        for d in shape:
            size *= int(d)
        n += size * int(itemsize)
    return n + int(n_units) * int(n_segs)


def chunk_bytes(n_keys: int, chunk_ticks: int, in_bytes_per_tick: int,
                out_ticks: int, out_bytes_per_tick: int,
                halo_ticks: int) -> int:
    """What one chunk's semantics need: the inputs the query reads, read
    once (``in_bytes_per_tick`` a key-tick), the output grid the step
    returns, written once, and the carried tails (``halo_ticks`` a key),
    read and written once."""
    per_key = (int(chunk_ticks) * int(in_bytes_per_tick)
               + int(out_ticks) * int(out_bytes_per_tick)
               + 2 * int(halo_ticks) * int(in_bytes_per_tick))
    return int(n_keys) * per_key


def share_pct(nbytes: float, seconds: float) -> float:
    """Least time for ``nbytes`` at the peak rate over ``seconds``, in %."""
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds


def over_picks(per_cap: Dict[int, int], picks: Dict[int, int]) -> float:
    """Bytes over the chunks of ``picks`` (``{capacity: chunks}``), given
    the bytes a chunk moves at each capacity."""
    return float(sum(per_cap[c] * n for c, n in picks.items() if n))
