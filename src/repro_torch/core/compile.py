"""TiLT codegen: planned IR → eager PyTorch evaluation (port of
``repro.core.compile``).

Every node evaluates to a ``(value, valid)`` pair of tensors on its own
statically-planned grid.  The fused mode walks the optimized DAG once; the
interpreted mode evaluates operator at a time with a device barrier after
each node (the event-centric baseline of the Fig. 10 ablation).  Both go
through the single node evaluator :func:`_eval_op`.  There is no ``jit``:
execution is eager, on the device the input tensors live on, and every
windowed aggregate goes through :mod:`repro_torch.kernels.ops`.

Tensors carry time on their last axis.  A keyed stream adds leading key
axes, which every node evaluator lets ride along (the reference ``vmap``s
instead).

Execution contract (used by parallel.py):

* ``input_specs[name]`` is the :class:`plan.InputSpec` halo contract: the
  caller must supply a grid covering ``(P₀ + t0, P₀ + t0 + length·prec]``
  for a partition whose output covers ``(P₀, P₀ + out_len·out_prec]``.
* Ticks before the global stream start are supplied as ``valid=False``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from . import fusion, ir
from .plan import ChangePlan, InputSpec, QueryPlan, plan_change, plan_query
from .reduction import get_reduction
from ..device import resolve
from ..kernels import ops as kops
from ..kernels import ref as kref

__all__ = ["InputSpec", "CompiledQuery", "compile_query", "eval_op"]


def _const_dtype(c) -> torch.dtype:
    """The dtype ``jnp.full`` gives a constant without x64: f32 / int32."""
    if isinstance(c, bool):
        return torch.bool
    if isinstance(c, int):
        return torch.int32
    if isinstance(c, float):
        return torch.float32
    dt = torch.as_tensor(c).dtype
    return {torch.float64: torch.float32, torch.int64: torch.int32}.get(dt, dt)


# ---------------------------------------------------------------------------
# the node evaluator (shared by fused and interpreted modes)
# ---------------------------------------------------------------------------

def _eval_op(n: ir.Node, qp: QueryPlan, sum_algo: str, device: torch.device,
             *args):
    """Evaluate one node given its arguments' ``(value, valid)`` grids
    (for ``Input``, the single caller-supplied NAME grid)."""
    out_plan = qp.plan_of(n)
    if isinstance(n, ir.Input):
        ((gv, gm),) = args
        return qp.input_align(n).apply(gv, gm)
    if isinstance(n, ir.Const):
        val = tree_map(lambda c: torch.full((out_plan.length,), c,
                                            dtype=_const_dtype(c),
                                            device=device), n.value)
        return val, torch.ones((out_plan.length,), dtype=torch.bool,
                               device=device)
    if isinstance(n, ir.Map):
        vs, oks = [], []
        for a, (av, aok) in zip(n.args, args):
            av, aok = qp.align(a, n).apply(av, aok)
            vs.append(av)
            oks.append(aok)
        if n.phi_aware:
            return n.fn(*zip(vs, oks))
        return n.fn(*vs), functools.reduce(torch.logical_and, oks)
    if isinstance(n, ir.Where):
        ((av, aok),) = args
        av, aok = qp.align(n.args[0], n).apply(av, aok)
        return av, aok & n.pred(av)
    if isinstance(n, ir.Shift):
        ((av, aok),) = args
        return qp.align(n.args[0], n, delta=n.delta).apply(av, aok)
    if isinstance(n, ir.Reduce):
        ((av, aok),) = args
        return _eval_reduce(n, av, aok, qp, sum_algo)
    if isinstance(n, ir.Interp):
        ((av, aok),) = args
        return _eval_interp(n, av, aok, qp)
    raise TypeError(type(n))  # pragma: no cover


# the single node evaluator, shared with the union-DAG body of
# repro_torch.multiquery
eval_op = _eval_op


def _eval_reduce(n: ir.Reduce, aval, avalid, qp: QueryPlan,
                 sum_algo: str = "block"):
    red = get_reduction(n.op)
    (arg,) = n.args
    aplan = qp.plan_of(arg)
    spec = qp.align(arg, n)  # window-end gather at output tick times
    payload = aval[n.field] if n.field is not None else aval
    w_ticks = n.window // aplan.prec

    if red.kind == "scan":
        chans = red.pre(payload)
        stacked = torch.stack([c.float() for c in chans], dim=0)
        sums, count = kops.sliding_sum(stacked, avalid, w_ticks,
                                       algo=sum_algo)
        # gather at output ticks, then apply post (cheaper after striding)
        sums_g = spec.take(sums)      # (C, *B, out_len)
        count_g = spec.take(count)
        val = red.post(tuple(sums_g), count_g)
        ok = (count_g > 0 if not red.empty_valid
              else torch.ones_like(count_g, dtype=torch.bool))
        return val, spec.mask(ok)

    if red.kind == "assoc":
        x = red.pre(payload)[0] if red.pre else payload
        vals, anyv = kops.sliding_assoc(x.unsqueeze(0), avalid, w_ticks,
                                        red.name)
        return spec.take(vals[0]), spec.mask(spec.take(anyv))

    # generic template (paper §6.1.2), plain torch: ``acc`` and ``result``
    # act elementwise on tensors; the window fold is a log-step scan of the
    # Acc combine over (state-initialised) ticks.
    state0 = red.init()
    states = torch.where(avalid, red.acc(state0, payload), state0)
    comb = red.combine or red.acc
    folded = kref.sliding_assoc_block_ref(states, w_ticks, comb, state0)
    _, count = kref.sliding_sum_ref(
        torch.zeros((1,) + tuple(avalid.shape), device=avalid.device),
        avalid, w_ticks)
    val = red.result(spec.take(folded))
    return val, spec.mask(spec.take(count) > 0)


def _eval_interp(n: ir.Interp, aval, avalid, qp: QueryPlan):
    (arg,) = n.args
    aplan = qp.plan_of(arg)
    spec = qp.align(arg, n)
    Ta = aplan.length
    dev = avalid.device
    # int32 indices, as the reference computes them without x64
    ar = spec.cached("arange", dev, lambda: np.arange(Ta, dtype=np.int32))
    last_idx = torch.cummax(torch.where(avalid, ar, -1), dim=-1).values
    rev = torch.cummax(torch.where(avalid.flip(-1), ar, -1),
                       dim=-1).values.flip(-1)
    next_idx = Ta - 1 - rev
    nxt_valid = rev >= 0

    tau = spec.cached("tau", dev, lambda: spec.tau.astype(np.int32))
    ib = spec.cached("ib", dev, lambda: np.clip(spec.idx, 0, Ta - 1))
    ia = spec.cached("ia", dev, lambda: np.clip(spec.ceil_idx, 0, Ta - 1))
    ib_ok = spec.cached("ib_ok", dev, lambda: spec.idx >= 0)

    def gather(leaf, i):
        i = i.clamp(0, Ta - 1).long()
        return torch.gather(leaf.expand(i.shape[:-1] + leaf.shape[-1:]),
                            -1, i)

    i0 = last_idx.index_select(-1, ib)
    e0 = (i0 >= 0) & ib_ok
    t0v = aplan.tick_time(i0)
    v0 = tree_map(lambda leaf: gather(leaf, i0), aval)
    gap0 = tau - t0v
    if n.mode == "hold":
        return v0, e0 & (gap0 <= n.max_gap)

    i1 = next_idx.index_select(-1, ia)
    e1 = nxt_valid.index_select(-1, ia)
    t1v = aplan.tick_time(i1)
    v1 = tree_map(lambda leaf: gather(leaf, i1), aval)
    gap1 = t1v - tau
    denom = (t1v - t0v).float()
    w = torch.where(denom > 0, gap0.float() / torch.clamp(denom, min=1.0),
                    0.0)
    out = tree_map(lambda a, b: a * (1 - w) + b * w, v0, v1)
    ok = e0 & e1 & (gap0 <= n.max_gap) & (gap1 <= n.max_gap)
    return out, ok


# ---------------------------------------------------------------------------
# compiler
# ---------------------------------------------------------------------------

def _input_device(inputs: Dict[str, tuple]) -> torch.device:
    """The device a query runs on: that of its inputs (CUDA for a query
    without inputs, or raise where there is none)."""
    for _, valid in inputs.values():
        return valid.device
    return resolve()


@dataclasses.dataclass
class CompiledQuery:
    """A TiLT query compiled for a fixed partition size.

    ``fn(inputs)`` evaluates the fused DAG eagerly on the inputs' device;
    ``run_interpreted`` evaluates operator at a time with a device barrier
    after every node (the event-centric execution model, for the Fig. 10
    ablation).  ``plan`` is the static artifact both share.
    ``change_plan`` is attached by ``compile_query(..., sparse=True)``.
    """

    root: ir.Node
    plan: QueryPlan
    fn: Callable[[Dict[str, tuple]], tuple]
    _node_fns: list  # [(name, evaluator, arg node ids, node)]
    change_plan: Optional[ChangePlan] = None

    @property
    def out_len(self) -> int:
        return self.plan.out_len

    @property
    def out_prec(self) -> int:
        return self.plan.out_prec

    @property
    def input_specs(self) -> Dict[str, InputSpec]:
        return self.plan.input_specs

    def run_interpreted(self, inputs: Dict[str, tuple]) -> tuple:
        """Evaluate operator at a time, with a device barrier after every
        node."""
        dev = _input_device(inputs)
        env: Dict[int, tuple] = {}
        out = None
        for _name, fn_i, arg_ids, node in self._node_fns:
            if isinstance(node, ir.Input):
                env[id(node)] = fn_i(dev, inputs[node.name])
            else:
                env[id(node)] = fn_i(dev, *[env[i] for i in arg_ids])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # operator-at-a-time barrier
            out = env[id(node)]
        return out


def compile_query(root: ir.Node, out_len: int, *, opt: bool = True,
                  sum_algo: str = "block",
                  sparse: bool = False) -> CompiledQuery:
    """Compile a TiLT query for partitions of ``out_len`` output ticks.

    ``opt`` runs the fusion passes; ``sum_algo`` picks the windowed-sum
    algorithm (``"block"`` or the paper's subtract-on-evict ``"soe"``, see
    :func:`repro_torch.kernels.ops.sliding_sum`).  With ``sparse=True`` the
    executable also carries a :class:`plan.ChangePlan` (per-source
    dirty-span dilation, derived from the halo contracts), which the
    change-compressed executors need — :func:`repro_torch.core.sparse.
    sparse_run` and ``Runner(exe, ExecPolicy(body="sparse"))`` — to skip
    partitions and keys whose inputs did not change.  ``out_len`` is then
    the *segment* length they compact over.
    """
    if opt:
        root = fusion.optimize(root)
    ir.validate(root)
    qp = plan_query(root, out_len)

    def eval_node(n: ir.Node, env_vals, memo, dev):
        if id(n) in memo:
            return memo[id(n)]
        if isinstance(n, ir.Input):
            args = (env_vals[n.name],)
        else:
            args = tuple(eval_node(a, env_vals, memo, dev) for a in n.args)
        out = _eval_op(n, qp, sum_algo, dev, *args)
        memo[id(n)] = out
        return out

    def fn(inputs: Dict[str, tuple]) -> tuple:
        return eval_node(root, inputs, {}, _input_device(inputs))

    node_fns = [(n.name, functools.partial(_eval_op, n, qp, sum_algo),
                 tuple(id(a) for a in n.args), n)
                for n in ir.topo_order(root)]
    return CompiledQuery(root=root, plan=qp, fn=fn, _node_fns=node_fns,
                         change_plan=plan_change(qp) if sparse else None)
