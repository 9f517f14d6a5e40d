"""Static query planning (paper §5.1 + §6): IR + partition size →
QueryPlan; port of ``repro.core.plan`` (the one-shot dense path:
``ChangePlan``, ``seg_range_affine`` and ``UnionPlan`` belong to later
slices).

TiLT's central systems claim is that a time-centric IR makes the query plan
a *static artifact*: grid extents, alignment index maps and halo contracts
are all resolved before execution, so the runtime is synchronization-free
and trivially parallel over both time partitions and keyed sub-streams.
This module is that artifact.  It owns, in exactly one place:

* :class:`GridPlan`  — the time grid ``(t0, length, prec)`` of every node,
  relative to the partition start (boundary.py supplies the extents).
* :class:`AlignSpec` — the static ``τ → index`` map used whenever a node
  reads an argument on a different grid (the snapshot *hold* rule,
  stream.py), including the affine-slice fast path that lowers common
  alignments (same precision, integer down-sampling) to strided slices
  instead of gathers.
* :class:`InputSpec` — the per-input halo contract: ``left_halo`` /
  ``right_halo`` / ``core`` ticks per partition (paper Fig. 6 shaded
  regions), plus the derived multi-hop exchange schedule
  (:meth:`InputSpec.halo_schedule` → halo.py) used when the timeline is
  sharded across devices.  Every executor in parallel.py consumes these
  fields instead of re-deriving the arithmetic.
* :class:`QueryPlan` — the whole bundle, built once per (query, out_len)
  by :func:`plan_query` and shared by the fused executable, the
  interpreted operator-at-a-time program, and all partitioned runners.

Grid/alignment conventions (shared with stream.py):

* A grid ``(t0, length, prec)`` holds tick ``i`` at time ``t0 + (i+1)·prec``
  and covers the half-open interval ``(t0, t0 + length·prec]``.
* The value of a temporal object at an arbitrary time ``τ`` is the value of
  the latest tick at or before ``τ``: index ``(τ - t0)//prec - 1``
  (< 0 ⇒ before the grid ⇒ φ).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch.utils._pytree import tree_map

from . import boundary, halo, ir

__all__ = ["GridPlan", "AlignSpec", "InputSpec", "QueryPlan", "plan_query"]


def _ceil_div(a, b):
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Grid extent of one node, relative to the partition start."""

    t0: int       # exclusive left edge (≤ 0: lookback halo)
    length: int   # ticks
    prec: int

    def tick_time(self, i):
        """Time of tick ``i`` (works on ints and integer arrays)."""
        return self.t0 + (i + 1) * self.prec

    def floor_index(self, tau):
        """Latest tick at or before ``τ`` (hold rule); may be out of range."""
        return (tau - self.t0) // self.prec - 1

    def ceil_index(self, tau):
        """Earliest tick at or after ``τ``; may be out of range."""
        return _ceil_div(tau - self.t0, self.prec) - 1


@dataclasses.dataclass(frozen=True)
class AlignSpec:
    """Static alignment of an argument grid onto an output grid.

    Reading argument ``a`` at output tick times ``τ_j − delta`` resolves, at
    plan time, to the numpy index map ``idx`` (hold rule).  ``in_range``
    marks output ticks whose read falls inside the argument grid — out-of-
    range reads are φ.  Time is the last axis of every tensor this spec
    applies to; leading key axes ride along.  The tensors built from the
    index maps are made once per device and kept (:meth:`cached`).
    """

    arg: GridPlan
    out: GridPlan
    delta: int = 0

    def __post_init__(self):
        j = np.arange(self.out.length, dtype=np.int64)
        tau = self.out.tick_time(j) - self.delta
        idx = self.arg.floor_index(tau)
        n = idx.shape[0]
        if n > 1:
            d = np.diff(idx)
            affine, step = bool(np.all(d == d[0])) and d[0] > 0, int(d[0])
        else:
            affine, step = True, 1
        object.__setattr__(self, "_tau", tau)
        object.__setattr__(self, "_idx", idx)
        object.__setattr__(self, "_affine", (affine, int(idx[0]) if n else 0,
                                             step))
        object.__setattr__(self, "_exact", bool(np.all(self.in_range)))
        object.__setattr__(self, "_tensors", {})

    @property
    def tau(self) -> np.ndarray:
        """Read times ``τ_j − delta`` (one per output tick)."""
        return self._tau

    @property
    def idx(self) -> np.ndarray:
        """Hold-rule argument index per output tick (may be out of range)."""
        return self._idx

    @property
    def ceil_idx(self) -> np.ndarray:
        """Earliest argument tick ≥ read time (linear-interp upper bound)."""
        return self.arg.ceil_index(self._tau)

    @property
    def in_range(self) -> np.ndarray:
        return (self._idx >= 0) & (self._idx < self.arg.length)

    @property
    def exact(self) -> bool:
        """True when every output tick reads inside the argument grid."""
        return self._exact

    def cached(self, key, device: torch.device, make) -> torch.Tensor:
        """The tensor ``make()`` (a numpy array) on ``device``, built on the
        first request for ``(key, device)`` and kept with this spec."""
        k = (key, str(device))
        t = self._tensors.get(k)
        if t is None:
            t = self._tensors[k] = torch.as_tensor(make(), device=device)
        return t

    # -- application ---------------------------------------------------------
    def take(self, value):
        """Gather leaves of a value pytree along the last (time) axis with
        the static index map, as a strided slice when the map is affine."""
        affine, start, step = self._affine
        n = self._idx.shape[0]

        def one(leaf):
            size = leaf.shape[-1]
            if affine and start >= 0 and start + (n - 1) * step + 1 <= size:
                return leaf[..., start:start + (n - 1) * step + 1:step]
            idx = self.cached(("idx", size), leaf.device,
                              lambda: np.clip(self._idx, 0, size - 1))
            return leaf.index_select(-1, idx)

        return tree_map(one, value)

    def mask(self, ok):
        """AND a gathered validity mask with the in-range mask (φ outside)."""
        if self.exact:
            return ok
        return ok & self.cached("in_range", ok.device, lambda: self.in_range)

    def apply(self, value, valid):
        """Align a ``(value, valid)`` grid pair onto the output grid."""
        return self.take(value), self.mask(self.take(valid))


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Per-input partition contract (paper Fig. 6).

    For a partition whose output covers ``(P₀, P₀ + core·prec_out]`` the
    caller must supply this input on the grid ``(P₀ + t0, P₀ + t0 +
    length·prec]``.  The grid splits into ``left_halo`` lookback ticks,
    ``core`` fresh ticks, and ``right_halo`` lookahead ticks — computed once
    here and consumed by every executor (parallel.py).
    """

    t0: int       # grid start relative to partition start (≤ 0: lookback)
    length: int   # total ticks (left_halo + core + right_halo)
    prec: int
    core: int     # fresh ticks per partition (output span / prec)

    @property
    def left_halo(self) -> int:
        """Lookback ticks before the partition start."""
        return -self.t0 // self.prec

    @property
    def right_halo(self) -> int:
        """Lookahead ticks past the partition end."""
        return self.length - self.left_halo - self.core

    def grid_plan(self) -> GridPlan:
        return GridPlan(t0=self.t0, length=self.length, prec=self.prec)

    def contract_t(self) -> tuple:
        """The ``(lookback, lookahead)`` *time-unit* demand this contract
        serves: the halo tick counts un-rounded back to time."""
        return self.left_halo * self.prec, self.right_halo * self.prec

    def halo_schedule(self) -> "halo.HaloSchedule":
        """The static multi-hop exchange schedule serving this contract
        when the timeline is sharded (one shard per ``core`` ticks): hop
        ``k`` pulls the slab ``k`` neighbours over, ``ceil(halo/core)``
        hops per side (see :mod:`.halo`).  Like the halo sizes
        themselves, this is a planning artifact — resolved once here,
        consumed by every sharded executor."""
        return halo.schedule(self.left_halo, self.right_halo, self.core)


@dataclasses.dataclass
class QueryPlan:
    """Everything static about one (query, partition size) pair."""

    root: ir.Node
    out_len: int
    out_prec: int
    node_plans: Dict[int, GridPlan]          # id(node) -> GridPlan
    input_specs: Dict[str, InputSpec]        # per input NAME (union of uses)
    _aligns: Dict[tuple, AlignSpec] = dataclasses.field(default_factory=dict)

    def plan_of(self, n: ir.Node) -> GridPlan:
        return self.node_plans[id(n)]

    def align(self, arg: ir.Node, out: ir.Node, delta: int = 0) -> AlignSpec:
        """AlignSpec for consumer ``out`` reading argument ``arg``."""
        key = (id(arg), id(out), delta)
        if key not in self._aligns:
            self._aligns[key] = AlignSpec(
                self.node_plans[id(arg)], self.node_plans[id(out)], delta)
        return self._aligns[key]

    def input_align(self, n: ir.Input) -> AlignSpec:
        """AlignSpec from the supplied NAME grid onto an Input node's grid."""
        key = ("input", n.name, id(n))
        if key not in self._aligns:
            self._aligns[key] = AlignSpec(
                self.input_specs[n.name].grid_plan(), self.node_plans[id(n)])
        return self._aligns[key]


def plan_query(root: ir.Node, out_len: int) -> QueryPlan:
    """Resolve every grid extent, alignment map and halo for one partition
    size.  Pure planning — no tensor is touched here."""
    out_prec = root.prec
    span = out_len * out_prec  # output window (0, span]
    node_plans, input_specs = _plan_grids([root], span)
    return QueryPlan(root=root, out_len=out_len, out_prec=out_prec,
                     node_plans=node_plans, input_specs=input_specs)


def _plan_grids(roots, span: int):
    """Grid extents + merged per-NAME input contracts for a (multi-)root DAG."""
    nb = boundary.node_bounds_multi(list(roots))
    node_plans: Dict[int, GridPlan] = {}
    name_bounds: Dict[str, boundary.Bounds] = {}
    name_prec: Dict[str, int] = {}
    for n in ir.topo_order_multi(list(roots)):
        b = nb[id(n)]
        t0 = -_ceil_div(b.lookback, n.prec) * n.prec
        t_hi = span + _ceil_div(b.lookahead, n.prec) * n.prec
        node_plans[id(n)] = GridPlan(t0=t0, length=(t_hi - t0) // n.prec,
                                     prec=n.prec)
        if isinstance(n, ir.Input):
            name_prec[n.name] = n.prec
            name_bounds[n.name] = (name_bounds[n.name].union(b)
                                   if n.name in name_bounds else b)
    input_specs: Dict[str, InputSpec] = {}
    for name, b in name_bounds.items():
        p = name_prec[name]
        t0 = -_ceil_div(b.lookback, p) * p
        t_hi = span + _ceil_div(b.lookahead, p) * p
        input_specs[name] = InputSpec(t0=t0, length=(t_hi - t0) // p, prec=p,
                                      core=span // p)
    return node_plans, input_specs
