"""Boundary resolution (paper §5.1); port of ``repro.core.boundary``.

The time-centric IR makes the *temporal lineage* of every node explicit:
the value of a node at time ``T`` depends on input values inside a statically
known interval ``[T - lookback, T + lookahead]``.  Boundary resolution walks
the DAG **top-down from the query output** and accumulates, per node, the
total (lookback, lookahead) in time units relative to the output domain.
Reading the bounds at the :class:`ir.Input` leaves yields the contract that
lets the runtime partition an unbounded stream into independent chunks with
halo overlap (paper Fig. 6) — the key to synchronization-free data
parallelism over *arbitrary* queries.  The contract places no ceiling on
depth: when the timeline is sharded across devices, halos deeper than the
per-shard span (including the merged multi-query contracts of
:func:`node_bounds_multi`) are served by the multi-hop exchange schedule
planned in plan.py/halo.py.  Reading them at interior nodes gives
compile.py the exact grid extent each intermediate temporal object needs.

Per-edge rules (consumer needs bounds ``B``; what does the argument need?):

* ``Map/Where``        ->  ``B`` widened by ``arg.prec`` when grids differ
                           (hold-alignment reads the latest tick ≤ τ).
* ``Shift(d)``         ->  ``B`` shifted by ``d`` (negative d → lookahead).
* ``Reduce(window=W)`` ->  ``B`` widened back by ``W``.
* ``Interp(max_gap=g)``->  ``B`` widened back by ``g`` (+ ahead ``g`` when
                           mode='linear').

The result is conservative (a superset of the exact lineage), which only
costs a few duplicated halo ticks, never correctness.  It is the halo
contract, as the reference plans it (``resolve``, ``halo_ticks``, the
planned ``InputSpec``).

``exact=True`` swaps in the exact rule for a ``Reduce`` of stride ``p`` and
window ``W``: its grid begins at ``-ceil(B.lookback / p)·p`` (plan.py), so
its earliest tick reads ``(-ceil(B.lookback / p)·p + p - W, …]`` and its
argument needs ``ceil(B.lookback / p)·p + W - p`` back (never below 0),
at most the conservative ``B.lookback + W``.  plan.py sizes every node's
grid from these bounds: the ticks the body evaluates.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from . import ir

__all__ = ["Bounds", "node_bounds", "node_bounds_multi", "resolve",
           "halo_ticks"]


@dataclasses.dataclass(frozen=True)
class Bounds:
    """Temporal extent needed of a node, relative to the output domain."""

    lookback: int = 0
    lookahead: int = 0

    def shift(self, delta: int) -> "Bounds":
        # consumer reads in[t - delta]: positive delta reaches further back.
        return Bounds(max(self.lookback + delta, 0),
                      max(self.lookahead - delta, 0))

    def widen(self, back: int = 0, ahead: int = 0) -> "Bounds":
        return Bounds(self.lookback + back, self.lookahead + ahead)

    def union(self, other: "Bounds") -> "Bounds":
        return Bounds(max(self.lookback, other.lookback),
                      max(self.lookahead, other.lookahead))


def _edge(n: ir.Node, a: ir.Node, b: Bounds, exact: bool) -> Bounds:
    """Bounds needed of argument ``a`` when consumer ``n`` needs ``b``."""
    if isinstance(n, (ir.Map, ir.Where)):
        return b.widen(back=a.prec if a.prec != n.prec else 0)
    if isinstance(n, ir.Shift):
        return b.shift(n.delta)
    if isinstance(n, ir.Reduce):
        if exact:
            p = n.prec
            return Bounds(max(-(-b.lookback // p) * p + n.window - p, 0),
                          b.lookahead)
        return b.widen(back=n.window)
    if isinstance(n, ir.Interp):
        ahead = n.max_gap if n.mode == "linear" else 0
        extra = a.prec if a.prec != n.prec else 0
        return b.widen(back=n.max_gap + extra, ahead=n.max_gap if ahead else 0)
    raise TypeError(f"unknown node {type(n)}")  # pragma: no cover


def node_bounds(root: ir.Node) -> Dict[int, Bounds]:
    """Bounds for every node in the DAG, keyed by ``id(node)``."""
    return node_bounds_multi([root])


def node_bounds_multi(roots, exact: bool = False) -> Dict[int, Bounds]:
    """Bounds over the *union* DAG of several query roots.

    Each root anchors ``Bounds()`` at the shared output domain; a node used
    by several queries (or that is one query's output and another's interior
    expression) accumulates the union of every consumer's demand — the halo
    contract of the multi-query shared plan.

    Reverse post-order guarantees every consumer is finalized before its
    arguments are visited, so a single pass suffices.  ``exact`` picks the
    exact ``Reduce`` rule (module docstring).
    """
    order = ir.topo_order_multi(list(roots))
    bounds: Dict[int, Bounds] = {id(r): Bounds() for r in roots}
    for n in reversed(order):
        b = bounds[id(n)]
        for a in n.args:
            eb = _edge(n, a, b, exact)
            prev = bounds.get(id(a))
            bounds[id(a)] = eb if prev is None else prev.union(eb)
    return bounds


def resolve(root: ir.Node) -> Dict[str, Bounds]:
    """Map each source Input name to its (lookback, lookahead) contract."""
    nb = node_bounds(root)
    out: Dict[str, Bounds] = {}
    for n in ir.free_inputs(root):
        b = nb[id(n)]
        out[n.name] = out[n.name].union(b) if n.name in out else b
    return out


def halo_ticks(root: ir.Node) -> Dict[str, tuple[int, int]]:
    """Per-input halo sizes in *input ticks* (left, right), rounded up.

    This is what the partitioned executor materializes as duplicated
    snapshots at partition boundaries (paper Fig. 6 shaded regions).
    """
    inputs = {n.name: n for n in ir.free_inputs(root)}
    out = {}
    for name, b in resolve(root).items():
        p = inputs[name].prec
        out[name] = (-(-b.lookback // p), -(-b.lookahead // p))
    return out
