"""Temporal-plan verifier: TiLT's lineage algebra, checked independently;
port of ``repro.analysis.planverify`` (pure IR and plan arithmetic).

The planning layer (:mod:`repro_torch.core.boundary` →
:mod:`repro_torch.core.plan`) derives each query's backward halo contract
once and everything downstream — partition grids, carried tails,
ChangePlan dilations, the fused sparse kernel's affine scan windows —
trusts it. This pass re-derives the per-input ``(lookback, lookahead)``
demand **from the IR itself**, by a separate traversal with its own per-op
edge rules (written from the op semantics, not imported from boundary.py),
then checks every planning artifact against the independent result:

* ``InputSpec`` halos must *cover* the derived demand (undersized ⇒ the
  partitioned executors read garbage at segment boundaries — error);
  wider-than-demand halos are conservative rounding — reported as info.
* Grid alignment identities: ``t0 = −left_halo·prec`` and
  ``core·prec = out_len·out_prec`` for every input.
* ``ChangePlan`` dilations must cover the derived demand
  (:meth:`repro_torch.core.plan.ChangePlan.check_covers`), and their affine
  lowering at the runner's geometry must cover the per-segment ranges
  recomputed from the derived demand — including the one-output-stride
  widening of the hold rule (:func:`repro_torch.core.sparse.seg_ranges`
  / :func:`repro_torch.core.sparse.affine_covers`).  An under-dilated plan
  means silently stale outputs; that must never depend on plan_change being
  right about itself.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core import ir
from ..core import sparse as sparse_mod
from ..core.plan import seg_range_affine
from .findings import Finding

__all__ = ["derive_bounds", "pass_plan"]


def _arg_demand(n: ir.Node, a: ir.Node, lb: int, la: int) -> Tuple[int, int]:
    """What ``(lookback, lookahead)`` must argument ``a`` satisfy for
    consumer ``n`` to be known over ``[t−lb, t+la]``?  Re-written from
    each op's semantics (time units):

    * Map/Where read args at the consumer's tick times through the hold
      rule (latest arg tick ≤ τ), which reaches up to ``a.prec`` further
      back when the grids differ.
    * Shift(d) reads ``in[t−d]``: the whole demand translates by ``d``
      (clamped at 0 — a shift cannot create negative reach).
    * Reduce(window=W) folds ``(t−W, t]``: lookback grows by ``W``.
    * Interp(max_gap=g) searches valid neighbours within ``g``: lookback
      grows by ``g`` (+ hold padding), and linear mode also looks ahead
      ``g`` for the right neighbour.
    """
    if isinstance(n, (ir.Map, ir.Where)):
        pad = a.prec if a.prec != n.prec else 0
        return lb + pad, la
    if isinstance(n, ir.Shift):
        return max(lb + n.delta, 0), max(la - n.delta, 0)
    if isinstance(n, ir.Reduce):
        return lb + n.window, la
    if isinstance(n, ir.Interp):
        pad = a.prec if a.prec != n.prec else 0
        if n.mode == "linear":
            return lb + n.max_gap + pad, la + n.max_gap
        return lb + n.max_gap + pad, la
    raise TypeError(f"unknown IR node {type(n).__name__}")


def derive_bounds(roots) -> Dict[str, Tuple[int, int]]:
    """Per-input-name ``(lookback, lookahead)`` demand of a (multi-root)
    DAG, anchored at the shared output domain.

    Forward demand propagation with a dominance memo: a node is
    re-expanded only when a strictly larger demand arrives, so shared
    sub-DAGs don't explode.  Because every edge rule distributes over
    componentwise max, propagating merged demands path-by-path converges
    to the same fixpoint as merge-then-propagate — but through different
    code than boundary.py, which is the point.
    """
    best: Dict[int, Tuple[int, int]] = {}
    req: Dict[str, Tuple[int, int]] = {}
    stack = [(r, 0, 0) for r in roots]
    while stack:
        n, lb, la = stack.pop()
        cur = best.get(id(n), (-1, -1))
        if lb <= cur[0] and la <= cur[1]:
            continue
        lb, la = max(lb, cur[0]), max(la, cur[1])
        best[id(n)] = (lb, la)
        if isinstance(n, ir.Input):
            o = req.get(n.name, (0, 0))
            req[n.name] = (max(o[0], lb), max(o[1], la))
            continue
        for a in n.args:
            alb, ala = _arg_demand(n, a, lb, la)
            stack.append((a, alb, ala))
    return req


def pass_plan(target) -> List[Finding]:
    """Verify the target's planning artifacts against the independently
    derived demand (see module docstring)."""
    out = []
    r = target.runner
    spec = r.spec
    if not spec.roots:
        out.append(Finding(
            "info", "plan", "opaque-body",
            "BodySpec carries no IR roots: the temporal demand cannot be "
            "re-derived — only internal plan consistency was checked",
            policy=target.policy))
        req = {}
    else:
        req = derive_bounds(spec.roots)
        missing = sorted(set(req) - set(spec.input_specs))
        if missing:
            out.append(Finding(
                "error", "plan", "input-without-contract",
                f"IR inputs {missing} have no InputSpec halo contract — "
                "the chunked executors would never supply their halos",
                policy=target.policy))
    span = spec.span
    for name in sorted(spec.input_specs):
        s = spec.input_specs[name]
        if s.t0 % s.prec:
            out.append(Finding(
                "error", "plan", "grid-misaligned",
                f"input {name!r}: grid start t0={s.t0} is not a multiple "
                f"of prec={s.prec} — tick times fall off the grid",
                policy=target.policy, target=name))
        if s.core * s.prec != span:
            out.append(Finding(
                "error", "plan", "span-misaligned",
                f"input {name!r}: core·prec = {s.core * s.prec} != "
                f"segment span {span} — fresh ticks don't tile the chunk",
                policy=target.policy, target=name))
        if name not in req:
            continue
        lb, la = req[name]
        have_lb, have_la = s.contract_t()
        if have_lb < lb or have_la < la:
            out.append(Finding(
                "error", "plan", "halo-undersized",
                f"input {name!r}: halo contract serves (lookback, "
                f"lookahead) = ({have_lb}, {have_la}) time units but the "
                f"IR demands ({lb}, {la}) — partitioned execution reads "
                "garbage at segment boundaries",
                policy=target.policy, target=name,
                provenance=f"left_halo={s.left_halo},prec={s.prec}"))
        slack = (s.left_halo - -(-lb // s.prec),
                 s.right_halo - -(-la // s.prec))
        if max(slack) > 0:
            out.append(Finding(
                "info", "plan", "halo-overwide",
                f"input {name!r}: halo is {slack} ticks wider than the "
                "derived demand needs — conservative (correct), but "
                "every chunk carries the extra ticks",
                policy=target.policy, target=name))
    cp = spec.change_plan
    if cp is None:
        return out
    if (cp.out_len, cp.out_prec) != (spec.out_len, spec.out_prec):
        out.append(Finding(
            "error", "plan", "changeplan-grid-mismatch",
            f"ChangePlan grid ({cp.out_len}, {cp.out_prec}) != body grid "
            f"({spec.out_len}, {spec.out_prec})",
            policy=target.policy))
    for name, field, have, need in cp.check_covers(req):
        out.append(Finding(
            "error", "plan", "changeplan-under-dilated",
            f"input {name!r}: ChangePlan {field} = {have} does not cover "
            f"the derived demand {need} — changes inside the uncovered "
            "span leave stale outputs marked clean",
            policy=target.policy, target=name,
            provenance=f"{field}:have={have},need={need}"))
    # affine coverage at this runner's geometry: the windows the fused
    # change-detection kernel actually scans, vs the per-segment ranges
    # required by the *derived* demand (with the hold rule's one-output-
    # stride widening — seg_ranges owns that ±1 arithmetic)
    for name in sorted(spec.input_specs):
        if name not in cp.specs or name not in req:
            continue
        s, sp = spec.input_specs[name], cp.specs[name]
        lb, la = req[name]
        i_lo, i_hi1 = sparse_mod.seg_ranges(
            lb, la, s.prec, grid_t0=-s.left_halo * s.prec, out_t0=0,
            out_prec=spec.out_prec, seg_len=spec.out_len, n_segs=r.n_segs)
        try:
            affine = seg_range_affine(
                sp.lookback, sp.lookahead, s.prec,
                grid_t0=-s.left_halo * s.prec, out_t0=0,
                out_prec=spec.out_prec, seg_len=spec.out_len)
        except ValueError:
            out.append(Finding(
                "warning", "plan", "no-affine-lowering",
                f"input {name!r}: segment span not stride-aligned — the "
                "fused kernel cannot serve this input (general seg_ranges "
                "fallback)", policy=target.policy, target=name))
            continue
        ok = sparse_mod.affine_covers(affine, i_lo, i_hi1)
        if not bool(np.all(ok)):
            bad = np.nonzero(~ok)[0].tolist()
            out.append(Finding(
                "error", "plan", "dilation-misses-segments",
                f"input {name!r}: the kernel's affine scan window misses "
                f"required dirty ticks for segments {bad} — changes there "
                "never mark the segment dirty (silently stale outputs)",
                policy=target.policy, target=name,
                provenance=f"affine={affine}"))
    return out
