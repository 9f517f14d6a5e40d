"""Multi-query session: N concurrent queries, one pass over the stream
(port of ``repro.multiquery.session``).

:class:`MultiQuerySession` is the serving-layer counterpart of the chunked
runner for *many* queries at once: registered queries are interned into a
:class:`repro_torch.multiquery.shared.SharedPlanCache`, planned together
as one union DAG (:func:`repro_torch.core.plan.plan_union`), and advanced
chunk by chunk through the policy runner (:class:`repro_torch.engine.
Runner` with ``ExecPolicy(dag="union")``) — every shared interior node is
evaluated once per chunk regardless of how many queries read it.

Cross-chunk state is the runner's state pytree under the *merged* halo
contract: per source name, the trailing ``left_halo`` ticks demanded by the
union of all attached queries.  Queries may attach/detach between chunks;
the carried halo is re-fitted to the new merged contract deterministically
(crop from the left when it shrinks, φ-pad on the left when it grows), so a
session that changes its query set stays bit-identical to a fresh session
restored from the same checkpoint.

Keyed sources compose as in the keyed runner: chunks carry a leading key
axis and K keyed sub-streams × N queries advance in one union evaluation
per chunk, and an optional mesh shards the key axis.  ``sparse=True``
composes change-compressed execution with multi-query sharing: the
merged :class:`~repro_torch.core.plan.ChangePlan` of the union DAG is the
per-input union of the per-query dilations, so segments (and keys) whose
dilated lineage saw no change skip the whole union evaluation and hold
every query's previous output.

The session runs on the device of the chunks it is given (the reference's
``pallas`` and ``jit`` knobs have no counterpart: the port is eager and
picks its kernels by device).  :func:`shard_union_run` is the
time-sharded union executor: the timeline sharded over a mesh axis, the
merged halo contracts assembled by the same hop chain as
:func:`repro_torch.core.parallel.shard_map_run`.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..core import boundary, compile as qcompile, ir, parallel
from ..core.plan import plan_change, plan_union
from ..core.stream import SnapshotGrid
from ..engine.policy import ExecPolicy, MeshPlacement
from ..engine.runner import BodySpec, Runner
from ..launch.mesh import axis_comm
from ..obs import Metrics
from .shared import SharedPlanCache, SharingReport

__all__ = ["MultiQuerySession", "shard_union_run", "union_body_spec",
           "union_runner"]

def _union_body(plan, queries, order, sum_algo, span, counts=None,
                fps=None):
    """The union-DAG evaluator (units on the leading axis, time last):
    every node once through the shared evaluator, then per-query output
    windows sliced off each root's (possibly union-widened) grid."""

    def body(full: Dict[str, tuple]) -> Dict[str, tuple]:
        dev = qcompile._input_device(full)
        env: Dict[int, tuple] = {}
        for n in order:
            if isinstance(n, ir.Input):
                args = (full[n.name],)
            else:
                args = tuple(env[id(a)] for a in n.args)
            if fps:
                counts[fps[id(n)]] = counts.get(fps[id(n)], 0) + 1
            env[id(n)] = qcompile.eval_op(n, plan, sum_algo, dev, *args)
        outs = {}
        for qname, root in queries.items():
            gp = plan.plan_of(root)
            lo = -gp.t0 // gp.prec        # skip any union-widened halo
            hi = lo + span // gp.prec
            v, m = env[id(root)]
            outs[qname] = (tree_map(lambda x: x[..., lo:hi], v),
                           m[..., lo:hi])
        return outs

    return body


def union_body_spec(plan, queries: Dict[str, ir.Node], *,
                    sum_algo: str = "block", counts: Optional[dict] = None,
                    sparse: bool = False) -> BodySpec:
    """The :class:`repro_torch.engine.runner.BodySpec` of a union DAG: one
    body evaluating every node once and fanning out per-query output
    windows.

    With ``sparse=True`` the spec carries the *merged* ChangePlan — the
    per-input union of the per-query dilations, obtained by reading the
    union plan's merged halo contracts backwards
    (:func:`repro_torch.core.plan.plan_change` on the
    :class:`~repro_torch.core.plan.UnionPlan`).  ``counts`` (a mutable
    dict) enables per-fingerprint node-evaluation counting — the sharing
    test hook.
    """
    order = ir.topo_order_multi(list(plan.roots))
    fps = ({id(n): ir.fingerprint(n) for n in order}
           if counts is not None else None)
    outs_fn = _union_body(plan, queries, order, sum_algo, plan.span,
                          counts=counts, fps=fps)
    return BodySpec(
        input_specs=plan.input_specs, out_len=plan.out_len,
        out_prec=plan.out_prec, outs_fn=outs_fn,
        out_precs={q: root.prec for q, root in queries.items()},
        change_plan=plan_change(plan) if sparse else None,
        root=None, solo=False,
        roots=tuple(queries[q] for q in sorted(queries)))


def union_runner(queries: Dict[str, object], span: int,
                 policy: Optional[ExecPolicy] = None, *,
                 n_keys: Optional[int] = None, segs_per_chunk: int = 1,
                 sum_algo: str = "block") -> Runner:
    """A :class:`repro_torch.engine.Runner` over the union DAG of
    ``queries`` (name → TStream or IR node) — the ``dag='union'`` corner of
    the policy space, without the session's attach/detach machinery."""
    queries = {name: getattr(q, "node", q) for name, q in queries.items()}
    for root in queries.values():
        ir.validate(root)
    policy = policy if policy is not None else ExecPolicy(dag="union")
    if not policy.union:
        raise ValueError(
            f"union_runner needs ExecPolicy(dag='union'), got {policy.dag!r}")
    plan = plan_union(list(queries.values()), span)
    spec = union_body_spec(plan, queries, sum_algo=sum_algo,
                           sparse=policy.sparse)
    return Runner(spec, policy, n_keys=n_keys, segs_per_chunk=segs_per_chunk)


def shard_union_run(queries: Dict[str, object], span: int,
                    inputs: Dict[str, SnapshotGrid], mesh,
                    axis: str = "data", *, sum_algo: str = "block"
                    ) -> Dict[str, SnapshotGrid]:
    """SPMD execution of N queries' union DAG with the *timeline* sharded
    along ``mesh[axis]`` — the multi-query counterpart of
    :func:`repro_torch.core.parallel.shard_map_run`, through the same
    ``place_core_inputs`` / ``stage_exchange_step`` / ``record_exchange``.

    ``span`` is the per-shard output span (time units); each input supplies
    exactly the core region of the global window (``n · span`` time units,
    shared by all queries), the same on every rank.  The merged per-source
    halo contracts of the union plan — which get *deeper* as queries pile
    on — are assembled by the same multi-hop chain as the per-query path,
    so union plans whose windows exceed the per-shard span shard fine.
    Every query's output grid comes back whole on every rank.  Unkeyed
    sources only (the keyed session shards the key axis instead).
    """
    queries = {name: getattr(q, "node", q) for name, q in queries.items()}
    for name, root in queries.items():
        ir.validate(root)
        if any(n.keyed for n in ir.free_inputs(root)):
            raise NotImplementedError(
                f"query {name!r}: shard_union_run time-shards unkeyed "
                "sources; keyed query sets shard the key axis via "
                "MultiQuerySession(mesh=...)")
    comm = axis_comm(mesh, axis)
    # plan + staged step depend only on the query-set structure and the
    # execution knobs — cache both, keyed structurally because callers
    # rebuild query dicts per call
    qkey = tuple(sorted((name, ir.fingerprint(root))
                        for name, root in queries.items()))

    def build():
        # interned, so nodes shared between queries evaluate once, as in
        # the session (under jit the reference gets this from XLA's CSE;
        # an eager evaluator does not)
        cache = SharedPlanCache()
        roots = {name: cache.intern(root) for name, root in queries.items()}
        plan = plan_union(list(roots.values()), span)
        order = ir.topo_order_multi(list(roots.values()))
        body = _union_body(plan, roots, order, sum_algo, span)
        return plan, parallel.stage_exchange_step(
            plan.input_specs, body, comm, axis,
            {qname: (axis, axis) for qname in queries})

    plan, sharded = parallel.lru_step_get(
        _union_step_cache,
        (qkey, span, comm.n, comm.rank, comm.serial, axis, sum_algo),
        build, _UNION_STEP_CACHE_MAX)
    placed, out_t0 = parallel.place_core_inputs(plan.input_specs, inputs,
                                                comm)
    parallel.record_exchange(plan.input_specs, placed, comm)
    outs = sharded(*placed)
    return {qname: SnapshotGrid(value=v, valid=m, t0=out_t0,
                                prec=queries[qname].prec)
            for qname, (v, m) in outs.items()}


# (qkey, span, axis geometry, sum_algo) -> (UnionPlan, step); structural
# fingerprints make the key process-stable, so rebuilding the same
# dashboard set every chunk never re-plans.  LRU-bounded: a long-lived
# server with an evolving query set must not grow without bound.
_UNION_STEP_CACHE_MAX = 16
_union_step_cache: "collections.OrderedDict[tuple, tuple]" = \
    collections.OrderedDict()


def _crop(x, lo: int):
    return x[..., lo:]


def _pad_left(x, pad: int, fill):
    """``pad`` ticks of ``fill`` before ``x`` on its time (last) axis; a
    numpy array stays numpy, a tensor stays a tensor on its device."""
    if torch.is_tensor(x):
        z = torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype,
                       device=x.device)
        return torch.cat([z, x], dim=-1)
    x = np.asarray(x)
    return np.concatenate([np.full(x.shape[:-1] + (pad,), fill, x.dtype),
                           x], axis=-1)


class MultiQuerySession:
    """Serve N concurrent queries from one pass over shared sources.

    Parameters
    ----------
    span:
        Output time units per chunk, shared by all queries (each query
        emits ``span // root.prec`` ticks per step).
    n_keys / mesh / axis:
        Keyed execution: required key count when sources are
        ``keyed=True``; an optional mesh shards the key axis along
        ``axis`` (as in the keyed runner: every rank attaches the same
        queries and steps the same global chunks).
    sparse:
        Change-compressed stepping: segments — and, when keyed, individual
        keys — whose dilated input lineage saw no change skip the union
        evaluation and hold every query's previous output (the merged
        ChangePlan of the union DAG; see the module docstring).
    sum_algo:
        The windowed-sum algorithm, passed through to the node evaluator
        (``"soe"`` runs the ``prefix_scan`` kernel).
    instrument:
        Count per-chunk node evaluations in ``node_eval_counts`` (keyed by
        structural fingerprint) — the sharing test hook.
    cache:
        A shared :class:`SharedPlanCache`; sessions may share one so
        interned plans persist across sessions.  A private cache by
        default.
    metrics:
        A :class:`repro_torch.obs.Metrics` registry for session + runner
        telemetry (``session.*`` and ``runner.*`` metric names), passed
        through every runner the session builds so counters survive
        attach/detach rebuilds; private by default.
    """

    def __init__(self, span: int, *, n_keys: Optional[int] = None,
                 mesh=None, axis: str = "data", sum_algo: str = "block",
                 instrument: bool = False, sparse: bool = False,
                 cache: Optional[SharedPlanCache] = None,
                 metrics: Optional[Metrics] = None):
        self.span = span
        self.n_keys = n_keys
        self.mesh = mesh
        self.axis = axis
        self.sum_algo = sum_algo
        self.instrument = instrument
        self.sparse = sparse
        self.cache = cache if cache is not None else SharedPlanCache()
        self.metrics = metrics if metrics is not None else Metrics()
        self.node_eval_counts: Dict[str, int] = {}
        self._queries: Dict[str, ir.Node] = {}   # name -> interned root
        self._plan = None
        self._runner: Optional[Runner] = None
        self._pending: Optional[Dict] = None  # state awaiting next rebuild
        self._dirty = True
        self._keyed: Optional[bool] = None

    # -- query registry ------------------------------------------------------
    def attach(self, name: str, query) -> ir.Node:
        """Register a query (TStream or IR node) under ``name``; takes
        effect at the next chunk.  Returns the interned canonical root."""
        root = getattr(query, "node", query)
        if name in self._queries:
            raise ValueError(f"query {name!r} already attached")
        ir.validate(root)
        if self.span % root.prec:
            raise ValueError(
                f"query {name!r}: span {self.span} not a multiple of "
                f"output precision {root.prec}")
        for src, b in boundary.resolve(root).items():
            if b.lookahead > 0:
                raise NotImplementedError(
                    f"query {name!r}: MultiQuerySession supports "
                    f"lookback-only queries (input {src} has lookahead)")
        keyed_flags = {n.keyed for n in ir.free_inputs(root)}
        if len(keyed_flags) > 1:
            raise ValueError(
                f"query {name!r} mixes keyed and unkeyed sources")
        q_keyed = keyed_flags.pop() if keyed_flags else None
        if q_keyed is not None:
            if self._keyed is not None and q_keyed != self._keyed:
                raise ValueError(
                    f"query {name!r}: keyed={q_keyed} conflicts with "
                    f"already-attached queries (keyed={self._keyed})")
            self._keyed = q_keyed
        if self._keyed and self.n_keys is None:
            raise ValueError("keyed sources need n_keys")
        if self.mesh is not None and not self._keyed:
            raise ValueError("mesh sharding requires keyed sources")
        canon = self.cache.intern(root)
        self._queries[name] = canon
        self._dirty = True
        self.metrics.counter("session.attaches", "queries attached").add(1)
        return canon

    def detach(self, name: str) -> None:
        """Drop a query; unaffected shared nodes keep their cached plans and
        the merged halo state is re-fitted at the next chunk."""
        if name not in self._queries:
            raise ValueError(f"no query {name!r} attached "
                             f"(have {sorted(self._queries)})")
        del self._queries[name]
        # recompute keyedness from what's left so a session that empties
        # out can be repopulated with either kind
        flags = {n.keyed for root in self._queries.values()
                 for n in ir.free_inputs(root)}
        self._keyed = flags.pop() if len(flags) == 1 else None
        self._dirty = True
        self.metrics.counter("session.detaches", "queries detached").add(1)

    @property
    def queries(self) -> Dict[str, ir.Node]:
        return dict(self._queries)

    @property
    def runner(self) -> Optional[Runner]:
        """The union runner of the current query set (``None`` before the
        first chunk; rebuilt after an attach or detach)."""
        return self._runner

    def sharing_report(self) -> SharingReport:
        return self.cache.report(self._queries)

    def eval_count(self, query_or_node) -> int:
        """Instrumented evaluation count of a node (by structural
        fingerprint) accumulated since session creation or the last
        ``reset()``; requires ``instrument=True``.  A shared node evaluates
        once per chunk however many queries read it."""
        node = getattr(query_or_node, "node", query_or_node)
        return self.node_eval_counts.get(ir.fingerprint(node), 0)

    # -- planning ------------------------------------------------------------
    def _rebuild(self) -> None:
        if not self._queries:
            raise ValueError("no queries attached")
        roots = list(self._queries.values())
        tracer = self.metrics.tracer
        with tracer.span("session.rebuild"):
            with tracer.span("plan"):
                plan = plan_union(roots, self.span)
            carry = self._pending
            if carry is None and self._runner is not None:
                # the live state re-fits where it lies (no host round trip)
                carry = self._runner.state(host=False)
            spec = union_body_spec(
                plan, self._queries, sum_algo=self.sum_algo,
                counts=self.node_eval_counts if self.instrument else None,
                sparse=self.sparse)
            policy = ExecPolicy(
                body="sparse" if self.sparse else "dense",
                keys="vmapped" if self._keyed else "single",
                # the mesh shards the key axis only (attach() rejects
                # unkeyed mesh sessions)
                placement=(MeshPlacement(self.mesh, self.axis)
                           if self.mesh is not None and self._keyed
                           else "local"),
                dag="union")
            runner = Runner(spec, policy,
                            n_keys=self.n_keys if self._keyed else None,
                            metrics=self.metrics)
            if carry is not None:
                with tracer.span("refit"):
                    runner.restore(self._refit(carry, plan), strict=False)
                self.metrics.counter(
                    "session.refits",
                    "carried state re-fits onto a changed contract").add(1)
        self._plan, self._runner = plan, runner
        self._pending = None
        self._dirty = False
        m = self.metrics
        m.counter("session.rebuilds", "plan+runner rebuilds").add(1)
        m.gauge("session.queries", "attached queries").set(len(self._queries))
        rep = self.sharing_report()
        m.gauge("session.union_nodes", "nodes in the union DAG").set(
            rep.union_nodes)
        m.gauge("session.shared_nodes",
                "union nodes read by more than one query").set(
            rep.shared_nodes)
        m.gauge("session.sharing_ratio",
                "independent-plan nodes per union node").set(
            float(rep.sharing_ratio))

    # -- halo-state re-fitting (attach/detach between chunks) ----------------
    @staticmethod
    def _fit_tail(tail, hl: int):
        """Re-fit a carried tail to the current merged contract: keep the
        trailing ``hl`` ticks, φ-padding on the left when history is short.
        The rule is deterministic, so a live session whose contract changed
        and a fresh session restored from the same checkpoint agree."""
        tv, tm = tail
        cur = np.shape(tm)[-1]
        if cur == hl:
            return tail
        if cur > hl:
            return (tree_map(lambda x: _crop(x, cur - hl), tv),
                    _crop(tm, cur - hl))
        return (tree_map(lambda x: _pad_left(x, hl - cur, 0), tv),
                _pad_left(tm, hl - cur, False))

    @staticmethod
    def _fit_dirty(d, hl: int):
        """Re-fit a carried dirty tail: crop from the left, or pad with
        *True* (unknown history is conservatively dirty — the φ-padded halo
        it describes must be recomputed, exactly what dense does there)."""
        cur = np.shape(d)[-1]
        if cur == hl:
            return d
        if cur > hl:
            return _crop(d, cur - hl)
        return _pad_left(d, hl - cur, True)

    def _refit(self, state: Dict, plan) -> Dict:
        """Translate a carried/checkpointed state onto a (possibly
        different) union contract: tails re-fit per source, sparse change
        state filtered to the surviving sources/queries.  Outputs or inputs
        absent from the state simply start fresh (their first segment is
        forced to compute), which keeps the rule deterministic."""
        st = dict(state)
        t = st.pop("__t")
        sp = st.pop("__sparse", None)
        out = {name: self._fit_tail(st[name], spec.left_halo)
               for name, spec in plan.input_specs.items() if name in st}
        out["__t"] = t
        if sp is not None and self.sparse:
            # 1-tick snapshots exist only for halo-free inputs.  When the
            # merged contract *shrinks* an input to halo-free (its deepest
            # reader detached), derive the snapshot from the old tail's
            # last tick — that is the tick the next chunk's tick 0 must
            # diff against — instead of dropping the history.
            prev = {}
            for n, s in plan.input_specs.items():
                if s.left_halo != 0:
                    continue
                if n in sp["prev"]:
                    prev[n] = sp["prev"][n]
                elif n in st and np.shape(st[n][1])[-1] >= 1:
                    prev[n] = self._fit_tail(st[n], 1)
            out["__sparse"] = {
                "dirty": {n: self._fit_dirty(sp["dirty"][n],
                                             plan.input_specs[n].left_halo)
                          for n in plan.input_specs if n in sp["dirty"]},
                "prev": prev,
                "seed": {q: v for q, v in sp["seed"].items()
                         if q in self._queries},
                "started": sp["started"]}
        elif sp is not None:
            out["__sparse"] = sp  # let the runner's validator reject it
        return out

    # -- execution -----------------------------------------------------------
    def step(self, chunks: Dict[str, SnapshotGrid]
             ) -> Dict[str, SnapshotGrid]:
        """Advance every attached query by one chunk of ``span`` time units.

        Each chunk grid supplies exactly ``spec.core`` fresh ticks per source
        (leading key axis first when keyed).  Returns one output grid per
        query name."""
        if self._dirty:
            self._rebuild()
        return self._runner.step(chunks)

    def prepare(self, chunks: Optional[Dict[str, SnapshotGrid]] = None
                ) -> Dict[str, str]:
        """Build the union runner of the current query set now and prepare
        each of its steps ahead of the next chunk (``Runner.
        install_executable``: captured as CUDA graphs on the card, built on
        the CPU) over the layout of ``chunks`` (default: zero f32 chunks on
        CUDA).  Returns ``{step label: "captured" | "eager"}``.  An attach
        or detach rebuilds the runner, and its steps are captured again."""
        if self._dirty:
            self._rebuild()
        return {label: self._runner.install_executable(key, label=label,
                                                       chunks=chunks)
                for label, key in self._runner.aot_keys()}

    def run(self, inputs: Dict[str, SnapshotGrid], n_chunks: int
            ) -> Dict[str, SnapshotGrid]:
        """Slice ``n_chunks`` chunks from full streams, step through them and
        stitch each query's outputs along time."""
        if self._dirty:
            self._rebuild()
        return self._runner.run(inputs, n_chunks)

    def reset(self) -> None:
        """Drop carried state (and instrumentation counters); the next
        chunk starts a fresh stream at t=0."""
        self._pending = None
        if self._runner is not None:
            self._runner.reset()
        self.node_eval_counts.clear()

    # -- checkpointing -------------------------------------------------------
    def state(self) -> Dict:
        """Checkpointable session state (host numpy copies): the merged halo
        dict plus the stream clock (and change metadata when sparse).
        Restoring into a session with a different query set is
        well-defined — tails re-fit to the new contract."""
        if self._pending is not None:  # restored but not yet rebuilt
            return dict(self._pending)
        if self._runner is not None:
            return self._runner.state()
        return {"__t": 0}

    def restore(self, state: Dict) -> None:
        """Take ``state`` (this package's :meth:`state`, or a reference
        session's carried in through :func:`repro_torch.convert.
        state_from_numpy`) at the next chunk."""
        self._pending = dict(state)
        self._dirty = True
