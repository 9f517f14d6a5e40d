"""Per-key low-watermarks over event times with configurable bounded
lateness (a copy of ``repro.ingest.watermark``, which uses no array
library at all).

The watermark is the ingestion pipeline's progress contract: it asserts
that no future event will carry a tick at or before it, so everything up
to the watermark can be sealed and executed.  Following the standard
low-watermark construction (MillWheel / Flink lineage; see
the reference's docs/architecture.md, "Out-of-order ingestion"):

* each key tracks the maximum event (end-)time observed so far
  (``max_seen``);
* the **frontier** is the minimum of ``max_seen`` over keys — the
  slowest key holds the whole stream back, which is what makes keyed
  disorder safe: a key whose events lag never has its chunks sealed out
  from under it;
* the **watermark** is ``frontier - lateness``: events are allowed to
  arrive up to ``lateness`` time units behind the newest event of their
  key and still land in an unsealed chunk.

Keys are discovered on first observation by default, so an idle key
never stalls the stream; pass ``keys=`` to declare the key universe up
front, in which case the watermark stays ``None`` until every declared
key has reported (the strict variant).  ``None`` watermarks mean "no
progress guarantee yet" — nothing seals.
"""
from __future__ import annotations

from typing import Hashable, Iterable, Optional

__all__ = ["WatermarkTracker"]


class WatermarkTracker:
    """Low-watermark over per-key maximum event times.

    Parameters
    ----------
    lateness:
        Bounded lateness in time units: how far behind its key's newest
        event an event may arrive and still be on time.
    keys:
        Optional declared key universe.  Without it, keys are discovered
        on first :meth:`observe` and only observed keys constrain the
        frontier.
    """

    def __init__(self, lateness: int,
                 keys: Optional[Iterable[Hashable]] = None):
        if lateness < 0:
            raise ValueError(f"lateness must be >= 0 (got {lateness})")
        self.lateness = int(lateness)
        self._declared = keys is not None
        self._max_seen: dict = (
            {k: None for k in keys} if keys is not None else {})

    def observe(self, t: int, key: Hashable = None) -> None:
        """Record an event time for ``key`` (monotonic max per key)."""
        if self._declared and key not in self._max_seen:
            raise KeyError(
                f"key {key!r} not in the declared key universe")
        cur = self._max_seen.get(key)
        if cur is None or t > cur:
            self._max_seen[key] = int(t)

    def heartbeat(self, t: int) -> None:
        """Advance every known key's clock to at least ``t`` — an empty
        punctuation event, for feeds that signal progress without data."""
        for k, cur in self._max_seen.items():
            if cur is None or t > cur:
                self._max_seen[k] = int(t)

    @property
    def frontier(self) -> Optional[int]:
        """min over keys of the max event time seen; ``None`` before any
        observation (or while a declared key is still silent)."""
        if not self._max_seen:
            return None
        vals = list(self._max_seen.values())
        if any(v is None for v in vals):
            return None
        return min(vals)

    @property
    def high(self) -> Optional[int]:
        """max over keys of the max event time seen (the newest event)."""
        vals = [v for v in self._max_seen.values() if v is not None]
        return max(vals) if vals else None

    @property
    def watermark(self) -> Optional[int]:
        """``frontier - lateness``: every tick at or before this is
        sealed-safe — no on-time event can still write it."""
        f = self.frontier
        return None if f is None else f - self.lateness

    def lag(self) -> Optional[int]:
        """``high - watermark``: how far the newest observed event runs
        ahead of the sealing point (skew across keys + the lateness
        allowance)."""
        h, w = self.high, self.watermark
        return None if (h is None or w is None) else h - w
