"""TiLT codegen: planned IR → eager PyTorch evaluation (port of
``repro.core.compile``).

Every node evaluates to a ``(value, valid)`` pair of tensors on its own
statically-planned grid.  The fused mode walks the optimized DAG once; the
interpreted mode evaluates operator at a time with a device barrier after
each node (the event-centric baseline of the Fig. 10 ablation).  Both go
through the single node evaluator :func:`_eval_op`, on the device the
input tensors live on; every windowed aggregate goes through
:mod:`repro_torch.kernels.ops`.  The fused mode runs each elementwise
region of an optimized query (:mod:`.region`) as one program, one launch
on the card, where its user functions trace to the program's op set;
``regions`` on the compiled query says which did.

Staging, as the reference's ``jax.jit``: ``trace_fn`` is the eager body;
with ``jit=True`` (the default) ``fn`` is
:class:`repro_torch.engine.capture.Staged` over it, which on a CUDA device
replays one captured CUDA graph per input geometry (captured at its first
use, after an eager warm-up) and on the CPU runs the same body eagerly
over the same static buffers; ``jit=False`` makes ``fn`` the eager body
itself.  The interpreted mode stages every node the same way.

Tensors carry time on their last axis.  A keyed stream adds leading key
axes, which every node evaluator lets ride along (the reference ``vmap``s
instead).

Execution contract (used by parallel.py):

* ``input_specs[name]`` is the :class:`plan.InputSpec` halo contract: the
  caller must supply a grid covering ``(P₀ + t0, P₀ + t0 + length·prec]``
  for a partition whose output covers ``(P₀, P₀ + out_len·out_prec]``, or
  only its last ``plan.evaluated(name).length`` ticks, the ones the body
  reads (the chunked runner gathers just those).
* Ticks before the global stream start are supplied as ``valid=False``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from . import fusion, ir, region
from .plan import ChangePlan, InputSpec, QueryPlan, plan_change, plan_query
from .reduction import get_reduction
from ..device import resolve
from ..engine.capture import Staged
from ..kernels import ops as kops
from ..kernels import ref as kref

__all__ = ["InputSpec", "CompiledQuery", "compile_planned", "compile_query",
           "eval_op"]


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
# user functions: subnormal constants flushed
# ---------------------------------------------------------------------------

def _flush(a, dtype: torch.dtype):
    """``a`` (an argument of a torch call) with a subnormal value of
    ``dtype`` replaced by a zero of its sign: a Python float on the host
    (as it rounds to f32), a 0-d floating tensor on its device (no host
    read)."""
    tiny = torch.finfo(dtype).tiny
    if isinstance(a, float):
        if abs(a) < 2 * tiny and abs(float(np.float32(a))) < tiny:
            return math.copysign(0.0, a)
        return a
    if torch.is_tensor(a) and a.dim() == 0 and a.is_floating_point():
        return torch.where(a.abs() < torch.finfo(a.dtype).tiny, a * 0, a)
    return a


class _FlushSubnormal(TorchFunctionMode):
    """Around a user function (``Map``'s and ``Where``'s): the constants it
    hands to torch calls on floating tensors are flushed to zero where they
    are subnormal in that tensor's dtype, as both reference backends do
    (XLA's CPU backend flushes a subnormal constant, and the TPU has no
    subnormals).  A constant meeting an integer tensor is kept, as the
    reference keeps it.  Subnormal *results* are not flushed, where both
    reference backends flush them (the port's contract in README.md)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dt = next((a.dtype for a in (*args, *kwargs.values())
                   if torch.is_tensor(a) and a.dim() > 0
                   and a.is_floating_point()), None)
        if dt is not None:
            args = tuple(_flush(a, dt) for a in args)
            kwargs = {k: _flush(v, dt) for k, v in kwargs.items()}
        return func(*args, **kwargs)


def _user(fn, *args):
    """``fn(*args)`` with its subnormal constants flushed."""
    with _FlushSubnormal():
        return fn(*args)


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
        return qp.input_align(n).apply(*qp.read(n.name, gv, gm))
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
            return _user(n.fn, *zip(vs, oks))
        return _user(n.fn, *vs), functools.reduce(torch.logical_and, oks)
    if isinstance(n, ir.Where):
        ((av, aok),) = args
        av, aok = qp.align(n.args[0], n).apply(av, aok)
        return av, aok & _user(n.pred, av)
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
        chans = [c.float() for c in red.pre(payload)]
        sums, count = kops.sliding_sum(chans, avalid, w_ticks,
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
        vals, anyv = kops.sliding_assoc((x,), avalid, w_ticks, red.name)
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

    ``fn(inputs)`` is the fused executable: staged (one captured graph per
    input geometry on a CUDA device, see the module docstring) under
    ``jit=True``, else ``trace_fn`` itself; ``jit`` records which, for the
    entry points that stage a step of their own around ``trace_fn``.  ``trace_fn`` is the eager
    body, which callers that stage their own step (the chunked runner, the
    sparse bodies, the SPMD steps) call inside their capture.
    ``run_interpreted`` evaluates operator at a time, one staged node at a
    time, with a device barrier after every node (the event-centric
    execution model, for the Fig. 10 ablation).  ``plan`` is the static
    artifact everything shares.  ``change_plan`` is attached by
    ``compile_query(..., sparse=True)``.  ``regions`` are the elementwise
    regions ``trace_fn`` runs as one program each (:mod:`.region`).
    """

    root: ir.Node
    plan: QueryPlan
    trace_fn: Callable[[Dict[str, tuple]], tuple]
    fn: Callable[[Dict[str, tuple]], tuple]
    _node_fns: list  # [(name, staged evaluator, arg node ids, node)]
    change_plan: Optional[ChangePlan] = None
    sum_algo: str = "block"
    jit: bool = True
    regions: region.Regions = dataclasses.field(
        default_factory=lambda: region.Regions({}))

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
                  sum_algo: str = "block", jit: bool = True,
                  sparse: bool = False) -> CompiledQuery:
    """Compile a TiLT query for partitions of ``out_len`` output ticks.

    ``opt`` runs the fusion passes; ``sum_algo`` picks the windowed-sum
    algorithm (``"block"`` or the paper's subtract-on-evict ``"soe"``, see
    :func:`repro_torch.kernels.ops.sliding_sum`); ``jit=False`` leaves
    ``fn`` (and the interpreted nodes) eager instead of staged.  With
    ``sparse=True`` the
    executable also carries a :class:`plan.ChangePlan` (per-source
    dirty-span dilation, derived from the halo contracts), which the
    change-compressed executors need — :func:`repro_torch.core.sparse.
    sparse_run` and ``Runner(exe, ExecPolicy(body="sparse"))`` — to skip
    partitions and keys whose inputs did not change.  ``out_len`` is then
    the *segment* length they compact over.  The fused body runs each
    elementwise region as one program (:mod:`.region`).
    """
    if opt:
        root = fusion.optimize(root)
    ir.validate(root)
    qp = plan_query(root, out_len)
    return compile_planned(root, qp, sum_algo=sum_algo, jit=jit,
                           change_plan=plan_change(qp) if sparse else None)


def compile_planned(root: ir.Node, qp: QueryPlan, *, sum_algo: str = "block",
                    jit: bool = True,
                    change_plan: Optional[ChangePlan] = None,
                    lower: bool = True) -> CompiledQuery:
    """The evaluator of an already optimized and planned query: what
    :func:`compile_query` returns, without running the planner (a warm
    serving start rebuilds ``qp`` from a persisted plan artifact, see
    :mod:`repro_torch.serve.loop`).  Each elementwise region runs as one
    program (:func:`.region.lower`); ``lower=False`` evaluates it call by
    call instead, what the lowering is held against."""
    regions = region.lower(root, qp) if lower else region.Regions({})

    def eval_node(n: ir.Node, env_vals, memo, dev):
        if id(n) in memo:
            return memo[id(n)]
        reg = regions.get(n)
        if reg is not None and reg.sources:
            out = reg.run([eval_node(a, env_vals, memo, dev)
                           for a in reg.sources])
            if out is not None:
                memo[id(n)] = out
                return out
        if isinstance(n, ir.Input):
            args = (env_vals[n.name],)
        else:
            args = tuple(eval_node(a, env_vals, memo, dev) for a in n.args)
        out = _eval_op(n, qp, sum_algo, dev, *args)
        memo[id(n)] = out
        return out

    def trace_fn(inputs: Dict[str, tuple]) -> tuple:
        return eval_node(root, inputs, {}, _input_device(inputs))

    stage = Staged if jit else (lambda f: f)
    node_fns = [(n.name, stage(functools.partial(_eval_op, n, qp, sum_algo)),
                 tuple(id(a) for a in n.args), n)
                for n in ir.topo_order(root)]
    return CompiledQuery(root=root, plan=qp, trace_fn=trace_fn,
                         fn=stage(trace_fn), _node_fns=node_fns,
                         change_plan=change_plan, sum_algo=sum_algo, jit=jit,
                         regions=regions)
