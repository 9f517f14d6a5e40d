"""Fixed-capacity FIFO admission ring for per-key event arrival (a copy of
``repro.serve.ring``, which uses no array library, on the port's
:class:`repro_torch.obs.Metrics`).

The serving loop's front door: producers :meth:`offer` events, the loop
:meth:`drain`\\ s them (in admission order) into the
:class:`repro_torch.ingest.IngestRunner`.  Capacity is fixed at
construction — the queue depth is bounded by design, and what happens at
the boundary is an explicit **shed policy** instead of an unbounded
backlog:

``"newest"``
    Refuse the incoming event (tail drop).  Arrival order of admitted
    events is untouched — the FIFO invariant the property tests pin.
``"oldest"``
    Evict the oldest queued event to admit the new one (head drop) —
    freshness-first serving.
``"block"``
    Raise :class:`Backpressure`; the caller owns the wait/retry loop.

Every admission decision lands on the shared zero-sync metrics registry
(``serve.queue_depth`` gauge, ``serve.admitted`` / ``serve.shed_events``
counters) — host-side integer arithmetic only, nothing on the device
path.  Entries carry their admission timestamp so the loop can observe
admission→result latency when the chunk that covers them seals.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from ..obs import Metrics

__all__ = ["AdmissionRing", "Backpressure", "RingEntry"]

_SHED = ("newest", "oldest", "block")


class Backpressure(RuntimeError):
    """Raised by ``shed='block'`` when the ring is full."""


@dataclasses.dataclass(frozen=True)
class RingEntry:
    """One admitted event: input name, the event, sub-stream key and the
    host admission timestamp (``time.perf_counter`` domain)."""

    name: str
    event: object
    key: int
    t_admit: float


class AdmissionRing:
    """Bounded FIFO over preallocated slots (head index + size; no
    allocation on the admit path)."""

    def __init__(self, capacity: int, *, shed: str = "newest",
                 metrics: Optional[Metrics] = None,
                 clock=time.perf_counter):
        if capacity < 1:
            raise ValueError("ring capacity must be >= 1")
        if shed not in _SHED:
            raise ValueError(f"unknown shed policy {shed!r} (one of {_SHED})")
        self.capacity = int(capacity)
        self.shed = shed
        self._clock = clock
        self._slots: List[Optional[RingEntry]] = [None] * self.capacity
        self._head = 0   # next entry to drain
        self._size = 0
        m = metrics if metrics is not None else Metrics()
        self.metrics = m
        self._m_depth = m.gauge(
            "serve.queue_depth", "events queued in the admission ring",
            "events")
        self._m_cap = m.gauge(
            "serve.ring_capacity", "admission ring capacity", "events")
        self._m_cap.set(self.capacity)
        self._m_admitted = m.counter(
            "serve.admitted", "events admitted into the ring", "events")
        self._m_shed = m.counter(
            "serve.shed_events",
            "events shed at capacity (policy=newest drops the arrival, "
            "policy=oldest evicts the head)", "events")

    def __len__(self) -> int:
        return self._size

    @property
    def depth(self) -> int:
        return self._size

    def offer(self, name: str, event, key: int = 0) -> bool:
        """Admit one event; returns whether it was admitted.  At capacity
        the shed policy decides (module docstring); ``shed='oldest'``
        admits by evicting, so it always returns True."""
        on = self.metrics.on
        if self._size == self.capacity:
            if self.shed == "block":
                raise Backpressure(
                    f"admission ring full ({self.capacity} events)")
            if on:
                self._m_shed.add(1)
            if self.shed == "newest":
                return False
            # oldest: evict the head to make room
            self._slots[self._head] = None
            self._head = (self._head + 1) % self.capacity
            self._size -= 1
        self._slots[(self._head + self._size) % self.capacity] = RingEntry(
            name=name, event=event, key=int(key), t_admit=self._clock())
        self._size += 1
        if on:
            self._m_admitted.add(1)
            self._m_depth.set(self._size)
        return True

    def drain(self, max_events: Optional[int] = None) -> List[RingEntry]:
        """Pop up to ``max_events`` entries (default: all) in admission
        order — the FIFO contract."""
        n = self._size if max_events is None else min(max_events, self._size)
        out = []
        for _ in range(n):
            out.append(self._slots[self._head])
            self._slots[self._head] = None
            self._head = (self._head + 1) % self.capacity
            self._size -= 1
        if self.metrics.on and out:
            self._m_depth.set(self._size)
        return out
