"""Operator fusion and IR-level optimization passes (paper §5.2); port of
``repro.core.fusion``.

In the time-centric model, fusion is *expression inlining*: two successive
temporal expressions over the same time domain merge by substituting the
producer's defining expression into the consumer — including across soft
pipeline-breakers (window reductions, joins) that defeat fusion in
event-centric engines (paper §3, Fig. 2).

Passes implemented here:

* :func:`cse`            — common-subexpression elimination on the DAG
                           (structural hashing).  The paper's trend query
                           (two windows over one source) relies on the shared
                           ``~stock`` read being deduplicated so the fused
                           loop reads the source once.
* :func:`fuse_elemwise`  — single-pass *maximal-region* fusion: every
                           connected region of elementwise nodes (Map/Where)
                           over one time domain collapses into a single Map
                           whose closure evaluates the whole region; inlined
                           Where predicates compose into one AND-mask
                           (φ-semantics preserved exactly).  After this pass
                           the DAG alternates {Reduce/Shift/Interp} nodes and
                           single fused Maps.
* :func:`fusion_report`  — before/after node census for the Fig.10-style
                           ablation benchmark.

In the eager PyTorch port, the effect of fusion is fewer nodes to evaluate
and one traversal per source; the unfused ("interpreted") execution mode in
compile.py evaluates every node separately with a device barrier after each,
reproducing the event-centric operator-at-a-time baseline.
"""
from __future__ import annotations

import functools

import torch

from . import ir

__all__ = ["cse", "fuse_elemwise", "optimize", "fusion_report"]


# ---------------------------------------------------------------------------
# structural CSE
# ---------------------------------------------------------------------------

def _structural_key(n: ir.Node, arg_keys: tuple) -> tuple:
    if isinstance(n, ir.Input):
        return ("input", n.name, n.prec, n.keyed)
    if isinstance(n, ir.Const):
        return ("const", repr(n.value), n.prec)
    if isinstance(n, ir.Map):
        return ("map", n.fn, n.prec, n.phi_aware, arg_keys)
    if isinstance(n, ir.Where):
        return ("where", n.pred, n.prec, arg_keys)
    if isinstance(n, ir.Shift):
        return ("shift", n.delta, n.prec, arg_keys)
    if isinstance(n, ir.Reduce):
        op_key = n.op if isinstance(n.op, str) else id(n.op)
        return ("reduce", op_key, n.window, n.prec, n.field, arg_keys)
    if isinstance(n, ir.Interp):
        return ("interp", n.mode, n.max_gap, n.prec, arg_keys)
    raise TypeError(type(n))


def cse(root: ir.Node) -> ir.Node:
    """Deduplicate structurally identical subexpressions."""
    canon: dict[tuple, ir.Node] = {}
    rewritten: dict[int, ir.Node] = {}
    keys: dict[int, tuple] = {}

    for n in ir.topo_order(root):
        new_args = tuple(rewritten[id(a)] for a in n.args)
        key = _structural_key(n, tuple(keys[id(a)] for a in n.args))
        if key in canon:
            rewritten[id(n)] = canon[key]
        else:
            m = n._replace_args(new_args) if n.args else n
            canon[key] = m
            rewritten[id(n)] = m
        keys[id(n)] = key
    return rewritten[id(root)]


# ---------------------------------------------------------------------------
# maximal-region elementwise fusion
# ---------------------------------------------------------------------------

def _is_elemwise(n: ir.Node) -> bool:
    if isinstance(n, ir.Map) and n.phi_aware:
        return False  # φ-aware closures keep their own validity logic
    return isinstance(n, (ir.Map, ir.Where))


def _use_counts(root: ir.Node) -> dict[int, int]:
    counts: dict[int, int] = {}
    for n in ir.topo_order(root):
        for a in n.args:
            counts[id(a)] = counts.get(id(a), 0) + 1
    counts[id(root)] = counts.get(id(root), 0) + 1
    return counts


def fuse_elemwise(root: ir.Node) -> ir.Node:
    """Collapse each maximal elementwise region into one fused Map.

    A node is *absorbable* into its consumer's region when it is elementwise,
    has a single use, and shares the consumer's time domain (equal precision
    — the paper's fusion precondition).  Region roots are elementwise nodes
    that are not absorbable themselves (multi-use, or consumed by a
    pipeline-breaker, or the query output).

    Inlined ``Where`` predicates compose into a single AND-mask: the fused
    region lowers to ``Map → Where(mask) → Map(unwrap)``, preserving
    φ-semantics exactly while the entire value pipeline runs in one closure.
    """
    counts = _use_counts(root)
    rewritten: dict[int, ir.Node] = {}

    def absorbable(x: ir.Node, region_prec: int) -> bool:
        return (_is_elemwise(x) and counts.get(id(x), 1) == 1
                and x.prec == region_prec)

    def rewrite(n: ir.Node) -> ir.Node:
        if id(n) in rewritten:
            return rewritten[id(n)]
        if _is_elemwise(n):
            m = build_region(n)
        else:
            new_args = tuple(rewrite(a) for a in n.args)
            same = all(a is b for a, b in zip(new_args, n.args))
            m = n if same else n._replace_args(new_args)
        rewritten[id(n)] = m
        return m

    def build_region(n: ir.Node) -> ir.Node:
        slots: list[ir.Node] = []          # fused Map arguments (rewritten)
        slot_of: dict[int, int] = {}       # id(original node) -> slot index
        region: set[int] = set()
        has_where = [isinstance(n, ir.Where)]

        def collect(x: ir.Node, is_root: bool = False):
            if not is_root and not absorbable(x, n.prec):
                if id(x) not in slot_of:
                    slot_of[id(x)] = len(slots)
                    slots.append(rewrite(x))
                return
            if id(x) in region:
                return
            region.add(id(x))
            if isinstance(x, ir.Where):
                has_where[0] = True
            for a in x.args:
                collect(a)

        collect(n, is_root=True)

        trivial = len(region) == 1 and isinstance(n, ir.Map)
        if trivial:
            new_args = tuple(rewrite(a) for a in n.args)
            same = all(a is b for a, b in zip(new_args, n.args))
            return n if same else n._replace_args(new_args)
        if len(region) == 1 and isinstance(n, ir.Where):
            (a0,) = n.args
            ra = rewrite(a0)
            return n if ra is a0 else n._replace_args((ra,))

        node_n = n

        def fused_fn(*vals):
            env: dict[int, object] = {}
            ok_terms: list = []

            def ev(x: ir.Node):
                if id(x) in env:
                    return env[id(x)]
                if id(x) in slot_of:
                    v = vals[slot_of[id(x)]]
                elif isinstance(x, ir.Map):
                    v = x.fn(*[ev(a) for a in x.args])
                elif isinstance(x, ir.Where):
                    v = ev(x.args[0])
                    ok_terms.append(x.pred(v))
                else:  # pragma: no cover
                    raise TypeError(type(x))
                env[id(x)] = v
                return v

            v = ev(node_n)
            if has_where[0]:
                ok = functools.reduce(torch.logical_and, ok_terms)
                return {"__v": v, "__ok": ok}
            return v

        fused = ir.Map.make(fused_fn, slots, prec=n.prec,
                            name=n.name + "_fused")
        if has_where[0]:
            gate = ir.Where.make(lambda d: d["__ok"], fused,
                                 name=n.name + "_gate")
            fused = ir.Map.make(lambda d: d["__v"], [gate], prec=n.prec,
                                name=n.name + "_unwrap")
        return fused

    return rewrite(root)


def optimize(root: ir.Node) -> ir.Node:
    """The default pass pipeline: CSE, then maximal-region fusion."""
    return fuse_elemwise(cse(root))


def fusion_report(before: ir.Node, after: ir.Node) -> dict:
    b, a = ir.topo_order(before), ir.topo_order(after)

    def census(nodes):
        out: dict[str, int] = {}
        for n in nodes:
            out[type(n).__name__] = out.get(type(n).__name__, 0) + 1
        return out

    def stages(nodes):
        """Materialization points: every op except the gate/unwrap
        bookkeeping a fused Where-region lowers to (one region == one
        stage regardless of its internal closure size)."""
        return sum(1 for n in nodes
                   if not n.name.endswith(("_gate", "_unwrap")))

    return {"nodes_before": len(b), "nodes_after": len(a),
            "stages_before": stages(b), "stages_after": stages(a),
            "census_before": census(b), "census_after": census(a)}
