"""Static query planning (paper §5.1 + §6): IR + partition size →
QueryPlan; port of ``repro.core.plan`` (``UnionPlan`` waits for the
multi-query slice, ROADMAP A11).

TiLT's central systems claim is that a time-centric IR makes the query plan
a *static artifact*: grid extents, alignment index maps and halo contracts
are all resolved before execution, so the runtime is synchronization-free
and trivially parallel over both time partitions and keyed sub-streams.
This module is that artifact.  It owns, in exactly one place:

* :class:`GridPlan`  — the time grid ``(t0, length, prec)`` of every node,
  relative to the partition start: the ticks its consumers read
  (boundary.py's exact bounds), so an input's evaluated window
  (:meth:`QueryPlan.evaluated`) may be a suffix of its contract's.
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
* :class:`ChangePlan` — the halo contracts read backwards: how far a
  changed input tick spreads through the query (sparse execution).

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

__all__ = ["GridPlan", "AlignSpec", "InputSpec", "QueryPlan", "plan_query",
           "UnionPlan", "plan_union", "ChangeSpec", "ChangePlan",
           "plan_change", "seg_range_affine"]


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
    _evaluated: Dict[str, GridPlan] = dataclasses.field(default_factory=dict)

    def plan_of(self, n: ir.Node) -> GridPlan:
        return self.node_plans[id(n)]

    def evaluated(self, name: str) -> GridPlan:
        """The ticks of input ``name`` the body reads: the union of its
        Input nodes' grids.  A suffix of the contract's window
        (``input_specs[name]``): both end at the same tick, and it starts
        later where no consumer reads the contract's first ticks (a
        ``Reduce`` reads less than the halo its window asks for)."""
        if not self._evaluated:
            roots = getattr(self, "roots", ()) or (self.root,)
            for n in ir.topo_order_multi(list(roots)):
                if not isinstance(n, ir.Input):
                    continue
                g, prev = self.node_plans[id(n)], self._evaluated.get(n.name)
                if prev is not None:
                    t0 = min(g.t0, prev.t0)
                    hi = max(g.tick_time(g.length - 1),
                             prev.tick_time(prev.length - 1))
                    g = GridPlan(t0=t0, length=(hi - t0) // g.prec,
                                 prec=g.prec)
                self._evaluated[n.name] = g
        return self._evaluated[name]

    def read(self, name: str, value, valid) -> tuple:
        """``(value, valid)`` of input ``name`` cut to :meth:`evaluated`:
        its last ``evaluated(name).length`` ticks, as views.  Callers pass
        the contract's window or the evaluated window itself."""
        n = self.evaluated(name).length

        def cut(x):
            return x[..., x.shape[-1] - n:] if x.shape[-1] > n else x

        return tree_map(cut, value), cut(valid)

    def align(self, arg: ir.Node, out: ir.Node, delta: int = 0) -> AlignSpec:
        """AlignSpec for consumer ``out`` reading argument ``arg``."""
        key = (id(arg), id(out), delta)
        if key not in self._aligns:
            self._aligns[key] = AlignSpec(
                self.node_plans[id(arg)], self.node_plans[id(out)], delta)
        return self._aligns[key]

    def input_align(self, n: ir.Input) -> AlignSpec:
        """AlignSpec from the NAME grid the body reads (:meth:`evaluated`)
        onto an Input node's grid."""
        key = ("input", n.name, id(n))
        if key not in self._aligns:
            self._aligns[key] = AlignSpec(
                self.evaluated(n.name), self.node_plans[id(n)])
        return self._aligns[key]


def plan_query(root: ir.Node, out_len: int) -> QueryPlan:
    """Resolve every grid extent, alignment map and halo for one partition
    size.  Pure planning — no tensor is touched here."""
    out_prec = root.prec
    span = out_len * out_prec  # output window (0, span]
    node_plans, input_specs = _plan_grids([root], span)
    return QueryPlan(root=root, out_len=out_len, out_prec=out_prec,
                     node_plans=node_plans, input_specs=input_specs)


@dataclasses.dataclass
class UnionPlan(QueryPlan):
    """A :class:`QueryPlan` over the *union* DAG of several query roots.

    One shared static artifact serves N concurrent queries: every node of
    every query gets a grid sized for the union of all consumers' demands
    (:func:`boundary.node_bounds_multi`), and ``input_specs`` is the merged
    per-source halo contract.  ``root``/``out_len``/``out_prec`` describe
    the first root only; per-query output extents come from each root's own
    :class:`GridPlan` (see :mod:`repro_torch.multiquery`).
    """

    roots: tuple = ()
    span: int = 0  # shared output span (0, span] in time units per chunk


def plan_union(roots, span: int) -> UnionPlan:
    """Plan the union DAG of several queries over one shared output span.

    All queries advance in lockstep: each chunk produces the output window
    ``(0, span]`` of every root (``span // root.prec`` ticks each), so
    ``span`` must be a multiple of every root's precision.  Shared nodes get
    a single grid covering every consumer; per-source contracts merge across
    queries.  Sources reached under the same name must agree on their grid
    declaration (prec / keyed).
    """
    roots = tuple(roots)
    if not roots:
        raise ValueError("plan_union needs at least one query root")
    for r in roots:
        if span % r.prec:
            raise ValueError(
                f"span {span} not a multiple of root {r.name} prec {r.prec}")
    decl: Dict[str, ir.Input] = {}
    for n in ir.topo_order_multi(list(roots)):
        if isinstance(n, ir.Input):
            prev = decl.get(n.name)
            if prev is not None and (prev.prec, prev.keyed) != (n.prec,
                                                               n.keyed):
                raise ValueError(
                    f"source {n.name!r} declared with conflicting grids: "
                    f"prec={prev.prec}/keyed={prev.keyed} vs "
                    f"prec={n.prec}/keyed={n.keyed}")
            decl[n.name] = n
    node_plans, input_specs = _plan_grids(roots, span)
    return UnionPlan(root=roots[0], out_len=span // roots[0].prec,
                     out_prec=roots[0].prec, node_plans=node_plans,
                     input_specs=input_specs, roots=roots, span=span)


def _grid(b: boundary.Bounds, prec: int, span: int) -> GridPlan:
    """The grid of ``prec`` covering ``(-b.lookback, span + b.lookahead]``."""
    t0 = -_ceil_div(b.lookback, prec) * prec
    t_hi = span + _ceil_div(b.lookahead, prec) * prec
    return GridPlan(t0=t0, length=(t_hi - t0) // prec, prec=prec)


def _plan_grids(roots, span: int):
    """Grid extents + merged per-NAME input contracts for a (multi-)root DAG.

    Node grids come from the exact bounds (what the body evaluates); the
    input contracts from the conservative ones, as the reference plans
    them (the halo carried, exchanged and checked)."""
    roots = list(roots)
    nb = boundary.node_bounds_multi(roots)
    eb = boundary.node_bounds_multi(roots, exact=True)
    node_plans: Dict[int, GridPlan] = {}
    name_bounds: Dict[str, boundary.Bounds] = {}
    name_prec: Dict[str, int] = {}
    for n in ir.topo_order_multi(roots):
        node_plans[id(n)] = _grid(eb[id(n)], n.prec, span)
        if isinstance(n, ir.Input):
            b = nb[id(n)]
            name_prec[n.name] = n.prec
            name_bounds[n.name] = (name_bounds[n.name].union(b)
                                   if n.name in name_bounds else b)
    input_specs: Dict[str, InputSpec] = {}
    for name, b in name_bounds.items():
        g = _grid(b, name_prec[name], span)
        input_specs[name] = InputSpec(t0=g.t0, length=g.length, prec=g.prec,
                                      core=span // g.prec)
    return node_plans, input_specs


@dataclasses.dataclass(frozen=True)
class ChangeSpec:
    """Per-input dirty-span dilation contract (change-compressed execution).

    Boundary resolution says output time ``τ`` reads this input inside
    ``[τ − lookback, τ + lookahead]``; the *reverse image* of that lineage
    interval is the dirty span: a changed input tick at time ``t`` can only
    alter outputs in ``[t − lookahead, t + lookback]``.  Both bounds are in
    time units and use the halo-rounded extents of :class:`InputSpec`, so
    the dilation is conservative exactly where the halo is.
    """

    lookback: int    # input change at t dirties outputs in [t, t+lookback]
    lookahead: int   # ... and in [t-lookahead, t]
    prec: int


@dataclasses.dataclass(frozen=True)
class ChangePlan:
    """Static change-propagation artifact for one (query, out_len) pair.

    The sparse executor (:mod:`repro_torch.core.sparse`) needs exactly one fact
    per source to turn per-tick dirty masks into dirty *output segments*:
    how far a change spreads through the query DAG.  That is the halo
    contract read backwards — window/interp/shift ops widen dirty spans by
    the same lookback/lookahead extents they demand as halo — so the plan
    is derived entirely from :class:`InputSpec` (no second DAG walk).
    """

    out_len: int                      # segment length in output ticks
    out_prec: int
    specs: Dict[str, ChangeSpec]      # per input NAME

    def check_covers(self, required: Dict[str, tuple]) -> list:
        """Verifier hook: does every per-input dilation cover a required
        ``{name: (lookback_t, lookahead_t)}`` demand (time units)?
        Returns one ``(name, field, have, need)`` tuple per shortfall —
        empty means every change an input sees really reaches every
        output it can affect.  Used by the temporal-plan verifier
        (the reference's ``repro.analysis``) with *independently
        re-derived* demands,
        so a bug in the :func:`plan_change` derivation (or a hand-built
        under-dilated plan) can't vouch for itself."""
        bad = []
        for name, (lb, la) in required.items():
            sp = self.specs.get(name)
            if sp is None:
                bad.append((name, "missing", None, (lb, la)))
                continue
            if sp.lookback < lb:
                bad.append((name, "lookback", sp.lookback, lb))
            if sp.lookahead < la:
                bad.append((name, "lookahead", sp.lookahead, la))
        return bad

    # -- retro-invalidation (late-data revision processing) ------------------
    def retro_span(self, name: str, t_lo: int, t_hi: int) -> tuple:
        """The *open* output-time interval ``(lo, hi)`` that changed input
        ticks of ``name`` at times in ``[t_lo, t_hi]`` can dirty — the
        reverse lineage image :func:`repro_torch.core.sparse.seg_ranges` resolves
        per segment, as one interval.  A late event that patches sealed
        input ticks in ``[t_lo, t_hi]`` can only change outputs strictly
        inside this span; everything else is provably unchanged (the
        sparse exactness contract), which is what makes revision
        processing a sparse re-run rather than a chunk replay."""
        sp = self.specs[name]
        return (t_lo - sp.lookahead - sp.prec,
                t_hi + sp.lookback + self.out_prec)

    def revision_horizon_chunks(self, lateness_bound: int,
                                chunk_span: int) -> int:
        """Snapshot-ring depth (in chunks) that guarantees revisability of
        any event no more than ``lateness_bound`` time units behind the
        sealed frontier.

        A patched tick at time ``t ≥ F − lateness_bound`` (``F`` the
        sealed frontier) dirties outputs ``τ > t − lookahead − prec``
        (:meth:`retro_span`), so the earliest chunk a revision must
        restart from is the one containing
        ``F − lateness_bound − lookahead − prec + 1`` — the ring must
        reach ``ceil((bound + lookahead + prec) / chunk_span)`` chunks
        back.  The ingest layer sizes its ring (and the sealed-raster
        buffer) with this; the ``revision`` analysis pass re-checks a
        configured runner against it."""
        slack = max((sp.lookahead + sp.prec for sp in self.specs.values()),
                    default=1)
        return max(1, -(-(lateness_bound + slack) // chunk_span))


def plan_change(qp: "QueryPlan") -> ChangePlan:
    """Derive the change-propagation plan from a query's halo contracts.

    Works unchanged on a :class:`UnionPlan`: its ``input_specs`` are the
    *merged* per-source contracts (union of every attached query's
    bounds), so the derived dilations are the per-input union of the
    per-query dilations — exactly the merged ChangePlan sparse multi-query
    execution needs (every output of every query in a segment is clean iff
    no input changed inside the union-dilated lineage).
    """
    specs = {name: ChangeSpec(lookback=s.left_halo * s.prec,
                              lookahead=s.right_halo * s.prec, prec=s.prec)
             for name, s in qp.input_specs.items()}
    return ChangePlan(out_len=qp.out_len, out_prec=qp.out_prec, specs=specs)


def seg_range_affine(lookback_t: int, lookahead_t: int, prec: int,
                     grid_t0: int, out_t0: int, out_prec: int,
                     seg_len: int) -> tuple:
    """Affine lowering of the dilated-lineage ranges: ``(a0, step, width)``
    such that segment ``k``'s dirty input-tick range is the half-open
    ``[a0 + k·step, a0 + k·step + width)``.

    This is :func:`repro_torch.core.sparse.seg_ranges` specialized to the case
    every chunked executor already enforces (segment span a multiple of the
    input precision), in the closed form the fused change-detection kernel
    needs: a *fixed-width* window sliding by a *fixed stride* per segment,
    so the kernel can map segment ``k`` straight to its input range.
    Raises ``ValueError`` when the span is not stride-aligned (callers fall
    back to the general per-segment ranges).
    """
    span = seg_len * out_prec
    if span % prec:
        raise ValueError(
            f"segment span {span} not a multiple of input precision {prec}"
            " — no affine lowering; use seg_ranges")
    step = span // prec
    lo_t = out_t0 + 1 - lookback_t
    hi_t = out_t0 + span + lookahead_t + prec - 1
    a0 = _ceil_div(lo_t - grid_t0, prec) - 1
    width = (hi_t - grid_t0) // prec - a0
    return a0, step, width
