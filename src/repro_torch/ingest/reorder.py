"""Static-shape reorder buffer: out-of-order events → in-order tick grids
(port of ``repro.ingest.reorder``).

The buffer owns the grid timeline of one input stream, cut into chunks of
``chunk_ticks`` ticks at precision ``prec`` starting at t=0 (the runner's
stream origin).  Events are rasterized **eagerly** on arrival into
per-chunk numpy rasters; arrival order never matters because every tick
carries the ``(start, end)`` stamp of the event that currently owns it,
and a write only lands where the new event wins the same deterministic
precedence :func:`repro_torch.core.stream.events_to_grid` resolves overlaps
with:

    new wins at a tick  iff  (start, end) >=_lex (owner.start, owner.end)

``events_to_grid`` writes events in sorted ``(start, end)`` order with
later writes overwriting, so the winner at any tick is the covering event
with the lexicographically largest ``(start, end)`` — exactly the stamp
rule above, under **any** arrival permutation.  (Two distinct events with
identical ``(start, end)`` spans and different payloads are ambiguous in
the in-order semantics too — don't do that.)  Values are staged in
float64 and cast to float32 at grid build, the same two-step
``events_to_grid`` performs, so sealed grids are bit-identical to
in-order rasterization.  The rasters live on the host (numpy); a sealed
grid is built on the buffer's device (CUDA unless ``"cpu"`` is asked for),
by an asynchronous copy from pinned memory on CUDA, so sealed chunks are
born on the card.

Chunks **seal** in order once the caller's watermark passes their span
(:meth:`seal_ready`); sealed rasters are retained in a bounded horizon
deque so late events can still **patch** them (:meth:`patch`) with the
same precedence rule — the patch reports exactly which tick times
changed, which is what the revision path dirties.  A patch that reaches
ticks older than the retained horizon is refused whole (nothing applied)
so sealed state never forks from what revisions can reproduce.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from ..core.stream import Event, SnapshotGrid
from ..device import resolve

__all__ = ["ReorderBuffer"]

_STAMP_MIN = np.iinfo(np.int64).min


class ReorderBuffer:
    """Reorder buffer for one input stream.

    Parameters
    ----------
    prec:
        Tick precision of this input's grid (time units per tick).
    chunk_ticks:
        Ticks per chunk (``input_spec.core * segs_per_chunk`` for the
        runner this feeds).
    n_keys / keyed:
        Key-axis geometry.  ``keyed=True`` builds ``(n_keys, T)`` grids
        (the runner's ``keys='vmapped'`` layout); otherwise grids are
        ``(T,)`` and ``n_keys`` must be 1.
    horizon_chunks:
        Sealed rasters retained for late patches (the revision horizon).
    device:
        Where sealed grids are built: CUDA unless ``"cpu"`` is asked for
        (raises without a CUDA device otherwise).
    """

    def __init__(self, prec: int, chunk_ticks: int, *, n_keys: int = 1,
                 keyed: bool = False, horizon_chunks: int = 1, device=None):
        if not keyed and n_keys != 1:
            raise ValueError("unkeyed buffers carry exactly one key")
        self.device = resolve(device)
        self.prec, self.T = int(prec), int(chunk_ticks)
        self.K, self.keyed = int(n_keys), keyed
        self.chunk_span = self.T * self.prec
        self.sealed_upto = 0            # chunks [0, sealed_upto) are sealed
        self._open: dict = {}           # chunk -> raster
        self._sealed: collections.deque = collections.deque(
            maxlen=int(horizon_chunks))  # (chunk, raster), oldest first
        self._pkeys = None              # payload structure (set on 1st event)
        self._is_dict = False
        self._last_tick = -1            # newest global tick any event wrote

    # -- payload structure ---------------------------------------------------
    def _register(self, ev: Event) -> None:
        if self._pkeys is None:
            self._is_dict = isinstance(ev.payload, dict)
            self._pkeys = (list(ev.payload.keys()) if self._is_dict
                           else ["v"])
        elif self._is_dict != isinstance(ev.payload, dict) or (
                self._is_dict and list(ev.payload.keys()) != self._pkeys):
            raise ValueError(
                f"event payload structure changed mid-stream "
                f"(expected fields {self._pkeys})")

    def _payload_vals(self, ev: Event) -> dict:
        return ev.payload if self._is_dict else {"v": ev.payload}

    # -- rasters -------------------------------------------------------------
    def _new_raster(self) -> dict:
        K, T = self.K, self.T
        return {
            "vals": {pk: np.zeros((K, T), np.float64)
                     for pk in (self._pkeys or ["v"])},
            "valid": np.zeros((K, T), bool),
            "s": np.full((K, T), _STAMP_MIN, np.int64),
            "e": np.full((K, T), _STAMP_MIN, np.int64),
        }

    def _open_raster(self, c: int) -> dict:
        r = self._open.get(c)
        if r is None:
            r = self._open[c] = self._new_raster()
        return r

    def _sealed_raster(self, c: int) -> Optional[dict]:
        for cc, r in self._sealed:
            if cc == c:
                return r
        return None

    def _write(self, raster: dict, k: int, lo: int, hi: int,
               ev: Event) -> np.ndarray:
        """Apply ``ev`` to in-chunk ticks ``lo..hi`` (inclusive) of key
        ``k`` under stamp precedence; returns the in-chunk indices that
        actually took the write."""
        s, e = raster["s"][k, lo:hi + 1], raster["e"][k, lo:hi + 1]
        win = (ev.start > s) | ((ev.start == s) & (ev.end >= e))
        idx = np.nonzero(win)[0] + lo
        if idx.size:
            raster["s"][k, idx] = ev.start
            raster["e"][k, idx] = ev.end
            raster["valid"][k, idx] = True
            for pk, val in self._payload_vals(ev).items():
                raster["vals"][pk][k, idx] = val
        return idx

    # -- ingest --------------------------------------------------------------
    def push(self, ev: Event, key: int = 0) -> Optional[tuple]:
        """Rasterize ``ev`` into the open (unsealed) chunks.

        Returns ``None`` when the event lies entirely at or past the
        sealed frontier, else the global tick-index range ``(a, b)``
        (inclusive) of the event's ticks that fall in **sealed** chunks —
        the late portion the caller must route through a lateness policy
        (:meth:`patch` / drop / re-admit).  The open portion is written
        either way."""
        p = self.prec
        a, b = ev.start // p, ev.end // p - 1
        if b < a:
            return None  # spans no tick
        self._register(ev)
        if b > self._last_tick:
            self._last_tick = b
        f = self.sealed_upto * self.T
        for c in range(max(a, f) // self.T, b // self.T + 1):
            lo = max(a, f, c * self.T)
            hi = min(b, (c + 1) * self.T - 1)
            if hi >= lo:
                self._write(self._open_raster(c), key,
                            lo - c * self.T, hi - c * self.T, ev)
        return (a, min(b, f - 1)) if a < f else None

    def patch(self, ev: Event, key: int = 0) -> tuple:
        """Apply the sealed portion of a late event to the retained
        sealed rasters.  Returns ``(times, beyond)``: the global tick
        **times** whose owner actually changed (the revision path's dirty
        set — empty when the event loses precedence everywhere), and
        ``beyond=True`` when any covered sealed tick is older than the
        retained horizon, in which case **nothing** is applied (refused
        whole: a partial patch would fork sealed state from anything a
        revision can reproduce)."""
        p, T = self.prec, self.T
        self._register(ev)
        a = ev.start // p
        b = min(ev.end // p - 1, self.sealed_upto * T - 1)
        if b < a or a < 0:
            if a < 0 and b >= 0:
                a = 0  # ticks before the stream origin don't exist
            else:
                return np.empty((0,), np.int64), False
        oldest = self.sealed_upto - len(self._sealed)
        if a // T < oldest:
            return np.empty((0,), np.int64), True
        times: list = []
        for c in range(a // T, b // T + 1):
            raster = self._sealed_raster(c)
            lo = max(a, c * T)
            hi = min(b, (c + 1) * T - 1)
            idx = self._write(raster, key, lo - c * T, hi - c * T, ev)
            times.extend((c * T + i + 1) * p for i in idx)
        return np.asarray(times, np.int64), False

    # -- sealing -------------------------------------------------------------
    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _grid(self, c: int, raster: Optional[dict]) -> SnapshotGrid:
        if raster is None:
            raster = self._new_raster()
        vals = {pk: v.astype(np.float32)
                for pk, v in raster["vals"].items()}
        valid = raster["valid"].copy()
        if not self.keyed:
            vals = {pk: v[0] for pk, v in vals.items()}
            valid = valid[0]
        vals = {pk: self._put(np.ascontiguousarray(v))
                for pk, v in vals.items()}
        value = vals if self._is_dict else vals["v"]
        return SnapshotGrid(value=value, valid=self._put(valid),
                            t0=c * self.chunk_span, prec=self.prec)

    def _seal_next(self) -> tuple:
        c = self.sealed_upto
        raster = self._open.pop(c, None)
        if raster is None:
            raster = self._new_raster()
        self._sealed.append((c, raster))
        self.sealed_upto = c + 1
        return c, self._grid(c, raster)

    def seal_ready(self, watermark: Optional[int]) -> list:
        """Seal (in order) every chunk whose span the watermark has fully
        passed; returns ``[(chunk_index, SnapshotGrid), ...]``."""
        out = []
        if watermark is None:
            return out
        while (self.sealed_upto + 1) * self.chunk_span <= watermark:
            out.append(self._seal_next())
        return out

    def seal_all(self, through_chunk: Optional[int] = None) -> list:
        """End-of-stream: seal through ``through_chunk`` (default: the
        last chunk any event wrote), watermark notwithstanding."""
        target = (self._last_tick // self.T if through_chunk is None
                  else through_chunk)
        out = []
        while self.sealed_upto <= target:
            out.append(self._seal_next())
        return out

    @property
    def last_chunk(self) -> int:
        """Chunk index of the newest tick any event wrote (-1: none)."""
        return self._last_tick // self.T if self._last_tick >= 0 else -1

    def sealed_grid(self, c: int) -> SnapshotGrid:
        """Rebuild the (possibly patched) grid of a sealed chunk still in
        the horizon — the revision walk's input."""
        raster = self._sealed_raster(c)
        if raster is None:
            raise KeyError(
                f"chunk {c} not retained (sealed horizon holds "
                f"{[cc for cc, _ in self._sealed]})")
        return self._grid(c, raster)
