"""Stream representations for TiLT (port of ``repro.core.stream``).

* :class:`EventStream` — host-side sequence of events ``(start, end,
  payload]``, the ingestion format.
* :class:`SnapshotGrid` — device-side dense materialization of a temporal
  object on the ``TDom`` precision grid: the value at every grid tick plus a
  validity mask (``valid == False`` encodes the null value φ).

Grid convention (the reference's, unchanged):

* All times are integers in an abstract base unit.
* A grid is parametrized by ``t0`` (exclusive left edge), precision ``p`` and
  length ``T``.  Tick ``i`` carries the value of the temporal object at time
  ``t0 + (i + 1) * p``; the grid covers ``(t0, t0 + T*p]``.
* An event ``(s, e, v]`` is active at time ``τ`` iff ``s < τ <= e``.
* Hold semantics: the value at an arbitrary time ``τ`` is that of tick
  ``(τ - t0)//p - 1`` (invalid if negative).

Time is the last axis of every tensor; a keyed grid carries a leading key
axis ``(K, T)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import resolve

__all__ = ["Event", "EventStream", "SnapshotGrid", "events_to_grid",
           "grid_to_events"]


@dataclasses.dataclass(frozen=True)
class Event:
    """A single event: payload valid on the half-open interval ``(start, end]``."""

    start: int
    end: int
    payload: Any  # scalar or dict-of-scalars

    def active_at(self, t: int) -> bool:
        return self.start < t <= self.end


class EventStream:
    """Host-side, time-ordered sequence of events (the paper's input format)."""

    def __init__(self, events: Sequence[Event], name: str = "stream"):
        self.events = sorted(events, key=lambda e: (e.start, e.end))
        self.name = name

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def value_at(self, t: int):
        """Oracle: payload of the event active at ``t`` or None (φ).

        With overlapping events, the *latest-starting* active event wins
        (matches events_to_grid, which writes events in start order).
        """
        hit = None
        for e in self.events:
            if e.active_at(t):
                hit = e.payload
        return hit

    @staticmethod
    def regular(values: Sequence[Any], period: int = 1, t0: int = 0,
                name: str = "stream") -> "EventStream":
        """Fixed-frequency signal: event ``k`` covers ``(t0+k*p, t0+(k+1)*p]``."""
        evs = [Event(t0 + k * period, t0 + (k + 1) * period, v)
               for k, v in enumerate(values)]
        return EventStream(evs, name=name)


@dataclasses.dataclass
class SnapshotGrid:
    """Dense on-grid materialization of a temporal object.

    ``value`` is a pytree of tensors whose last axis is time (length T);
    ``valid`` is a bool tensor of the same shape (False == φ).  ``t0`` and
    ``prec`` are plain ints.
    """

    value: Any             # pytree of tensors, last axis T
    valid: torch.Tensor    # bool[..., T]
    t0: int
    prec: int

    @property
    def length(self) -> int:
        return int(self.valid.shape[-1])

    @property
    def t_end(self) -> int:
        return self.t0 + self.length * self.prec

    def tick_time(self, i: int) -> int:
        return self.t0 + (i + 1) * self.prec

    def leaves(self):
        return pytree.tree_leaves(self.value)

    def replace(self, **kw) -> "SnapshotGrid":
        return dataclasses.replace(self, **kw)


def events_to_grid(stream: EventStream, t0: int, t_end: int, prec: int,
                   fill: float = 0.0, dtype=torch.float32,
                   device=None) -> SnapshotGrid:
    """Grid-snap an event stream onto ``TDom(t0, t_end, prec)``, on
    ``device`` (CUDA unless ``"cpu"`` is asked for).

    Ticks with no active event get ``valid=False`` (φ).  Overlapping events:
    the latest-starting event wins.
    """
    if (t_end - t0) % prec:
        raise ValueError("grid extent must be a multiple of prec")
    dev = resolve(device)
    T = (t_end - t0) // prec

    sample = stream.events[0].payload if stream.events else 0.0
    is_dict = isinstance(sample, dict)
    keys = list(sample.keys()) if is_dict else None

    vals = {k: np.full((T,), fill, dtype=np.float64) for k in (keys or ["v"])}
    valid = np.zeros((T,), dtype=bool)

    for e in stream.events:
        # tick i lives at τ_i = t0 + (i+1)p and is covered iff s < τ_i <= e
        first_i = (e.start - t0) // prec
        last_i = (e.end - t0) // prec - 1
        a = max(0, first_i)
        b = min(T - 1, last_i)
        if b < a:
            continue
        if is_dict:
            for k in keys:
                vals[k][a:b + 1] = e.payload[k]
        else:
            vals["v"][a:b + 1] = e.payload
        valid[a:b + 1] = True

    def put(a):
        return torch.as_tensor(a).to(dtype).to(dev)

    value = ({k: put(v) for k, v in vals.items()} if is_dict
             else put(vals["v"]))
    return SnapshotGrid(value=value, valid=torch.as_tensor(valid, device=dev),
                        t0=t0, prec=prec)


def grid_to_events(grid: SnapshotGrid) -> EventStream:
    """Change-compress a single-stream grid back into events (inverse of
    events_to_grid): consecutive valid ticks with equal payload merge."""
    valid = grid.valid.cpu().numpy()
    value = pytree.tree_map(lambda x: x.cpu().numpy(), grid.value)
    is_dict = isinstance(value, dict)
    T = valid.shape[0]

    def payload_at(k):
        return ({kk: vv[k].item() for kk, vv in value.items()}
                if is_dict else value[k].item())

    events: list[Event] = []
    i = 0
    while i < T:
        if not valid[i]:
            i += 1
            continue
        j = i
        pi = payload_at(i)
        while j + 1 < T and valid[j + 1] and payload_at(j + 1) == pi:
            j += 1
        # ticks i..j  ->  times (t0 + i*p, t0 + (j+1)*p]
        events.append(Event(grid.t0 + i * grid.prec,
                            grid.t0 + (j + 1) * grid.prec, pi))
        i = j + 1
    return EventStream(events)
