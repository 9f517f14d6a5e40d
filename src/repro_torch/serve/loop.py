"""The serving loop: a runner prepared ahead of time + a double-buffered
data path to the card + ring-buffer event admission (port of
``repro.serve.loop``).

:class:`ServeLoop` wraps one :class:`repro_torch.engine.Runner`:

* :meth:`ServeLoop.warm` prepares every step ahead of the first chunk
  (:func:`repro_torch.serve.aot.aot_capture`): on the card each step's
  CUDA graph is captured, so serving records no capture after it.
* :meth:`ServeLoop.serve` is the chunk path.  Requests are host numpy
  grids.  Chunk k+1's grids are copied into pinned memory and sent by a
  ``non_blocking`` copy on a side CUDA stream *before* chunk k's step is
  issued, so the transfer overlaps the step; an event orders each copy
  before the step that reads it.  A steady chunk then copies its grids
  into the runner's buffers and replays one graph: it makes no
  synchronizing call (PyTorch's sync debug mode counts none; the loop's
  own wait for a finished result, when it blocks, is an event wait, as
  the reference's ``block_until_ready``).
* :meth:`ServeLoop.attach_events` + :meth:`ServeLoop.offer` /
  :meth:`ServeLoop.pump` is the event path: a fixed-capacity
  :class:`repro_torch.serve.ring.AdmissionRing` feeds the
  disorder-tolerant :class:`repro_torch.ingest.IngestRunner`, whose
  sealed (and revised) chunks are staged by the same copy to the card,
  and admission→result latency is observed per sealed chunk.

:func:`build_service` is the one-call constructor that wires the
persisted caches: plan artifacts by structural fingerprint
(:class:`repro_torch.multiquery.SharedPlanCache`) + capture manifests
(:class:`repro_torch.serve.aot.ExecutableCache`).  A fresh process whose
caches are warm rebuilds its runner without planning and without
evaluating the body; unlike the reference it still captures its graphs,
since a CUDA graph cannot be persisted.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..core import compile as qc
from ..core import fusion, ir
from ..core.plan import QueryPlan
from ..core.stream import SnapshotGrid
from ..device import resolve
from ..engine import ExecPolicy, Runner
from ..engine.runner import BodySpec, body_spec_of
from ..ingest import IngestRunner
from ..multiquery import SharedPlanCache
from ..obs import Metrics, log_buckets
from .aot import (ExecutableCache, aot_capture, manifest_fits,
                  step_fingerprint)
from .ring import AdmissionRing

__all__ = ["ServeLoop", "build_service", "plan_artifact_of",
           "body_spec_from_artifact"]

_tm = tree_map


def plan_artifact_of(runner: Runner) -> Dict:
    """The pure-data planning artifact of a solo runner's body — what a
    warm process needs to rebuild an equivalent :class:`BodySpec` without
    planning: per-input halo contracts, output geometry, the ChangePlan,
    the window-sum algorithm and every node's grid, in the optimized
    query's topological order beside the node's kind (a Python function
    in the query does not pickle, so the body itself is rebuilt from the
    query; the artifact is stored under the fingerprint of the query
    before optimization, which the optimizer's output follows)."""
    spec = runner.spec
    if not spec.solo or spec.plan is None:
        raise ValueError("a plan artifact needs a solo body built by "
                         "compile_query")
    return {"input_specs": dict(spec.input_specs),
            "out_len": spec.out_len, "out_prec": spec.out_prec,
            "out_precs": dict(spec.out_precs),
            "change_plan": spec.change_plan, "solo": spec.solo,
            "sum_algo": spec.sum_algo,
            "grids": [(_kind(n), spec.plan.plan_of(n))
                      for n in ir.topo_order(spec.root)]}


def _kind(n: ir.Node) -> tuple:
    """A node's kind, precision and arity: what an artifact's grid is
    checked against when it is laid over a rebuilt query."""
    return (type(n).__name__, n.prec, len(n.args))


def body_spec_from_artifact(art: Dict, root: ir.Node
                            ) -> Optional[BodySpec]:
    """A :class:`BodySpec` for the query ``root`` rebuilt from a persisted
    plan artifact: the IR optimizer runs (the body is the query's own
    functions), the planner does not — every node's grid, the halo
    contracts and the ChangePlan come from the artifact.  ``None`` when
    the optimized query does not match the artifact node for node."""
    opt = fusion.optimize(root)
    order = ir.topo_order(opt)
    grids = art.get("grids") or []
    if len(order) != len(grids) or any(
            _kind(n) != kind for n, (kind, _g) in zip(order, grids)):
        return None
    qp = QueryPlan(root=opt, out_len=art["out_len"],
                   out_prec=art["out_prec"],
                   node_plans={id(n): g for n, (_k, g) in zip(order, grids)},
                   input_specs=dict(art["input_specs"]))
    return body_spec_of(qc.compile_planned(
        opt, qp, sum_algo=art["sum_algo"], change_plan=art["change_plan"]))


class _Staged:
    """One request's grids on the serving device, and the event that marks
    their copy done (``None`` on the CPU)."""

    __slots__ = ("grids", "event")

    def __init__(self, grids, event):
        self.grids, self.event = grids, event


def _host(x) -> np.ndarray:
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


class ServeLoop:
    """One served runner: ahead-of-time preparation + double-buffered
    chunk path + ring-admitted event path.  ``serve.*`` telemetry lands on
    the runner's metrics registry."""

    def __init__(self, runner: Runner, *,
                 exec_cache: Optional[ExecutableCache] = None,
                 query_fp: Optional[str] = None, device=None):
        self.runner = runner
        self.exec_cache = exec_cache
        self.query_fp = query_fp
        self.device = resolve(device)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        m = self.metrics = runner.metrics
        self._m_call = m.histogram(
            "serve.call_seconds", log_buckets(1e-5, 10.0, per_decade=3),
            "end-to-end per-call serving latency (dispatch + device "
            "completion)", "s", log_scale=True)
        self._m_admit = m.histogram(
            "serve.admit_to_result_seconds",
            log_buckets(1e-5, 100.0, per_decade=2),
            "ring admission to sealed-result latency", "s", log_scale=True)
        self._m_first = m.gauge(
            "serve.first_result_seconds",
            "construction to first blocked result", "s")
        self._t_created = time.perf_counter()
        self._first_done = False
        self.aot_report: Dict[str, str] = {}
        self.plan_source = "cold"
        self.ring: Optional[AdmissionRing] = None
        self.ingest: Optional[IngestRunner] = None
        self._admits: Dict[int, list] = {}

    # -- ahead-of-time preparation -------------------------------------------
    def warm(self, chunks: Optional[Dict] = None) -> Dict[str, str]:
        """Prepare every step the runner runs (captured on the card, built
        on the CPU) over the layout of ``chunks`` (host grids; default
        zero f32 chunks); returns ``{label: "captured" | "eager"}``."""
        staged = (self._ready(self._put(chunks)) if chunks is not None
                  else None)
        self.aot_report = aot_capture(self.runner, self.exec_cache,
                                      chunks=staged, query_fp=self.query_fp,
                                      device=self.device)
        return self.aot_report

    # -- chunk path ----------------------------------------------------------
    def _put(self, chunks: Dict[str, SnapshotGrid]) -> _Staged:
        """Stage one request's host grids on the serving device: each leaf
        is copied into pinned memory, then by a ``non_blocking`` copy on
        the side stream into a device tensor (ordered after the work
        already issued on the compute stream, which may still read memory
        the allocator hands out again); an event marks the copies done."""
        if self._side is None:
            return _Staged({name: SnapshotGrid(
                value=_tm(lambda x: torch.from_numpy(_host(x).copy()),
                          g.value),
                valid=torch.from_numpy(_host(g.valid).copy()), t0=g.t0,
                prec=g.prec) for name, g in chunks.items()}, None)
        d = self.device
        cur = torch.cuda.current_stream(d)
        pinned = {name: (_tm(lambda x: torch.from_numpy(
                             np.ascontiguousarray(_host(x))).pin_memory(),
                             g.value),
                         torch.from_numpy(np.ascontiguousarray(
                             _host(g.valid))).pin_memory())
                  for name, g in chunks.items()}
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            on_card = {name: _tm(lambda x: x.to(d, non_blocking=True), pv)
                       for name, pv in pinned.items()}
            done = torch.cuda.Event()
            done.record(self._side)
        grids = {name: SnapshotGrid(value=on_card[name][0],
                                    valid=on_card[name][1], t0=g.t0,
                                    prec=g.prec)
                 for name, g in chunks.items()}
        return _Staged(grids, done)

    def _ready(self, staged: _Staged) -> Dict[str, SnapshotGrid]:
        """The staged grids, with the compute stream ordered after their
        copy (no host wait) and their memory marked as used there."""
        if staged.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.event)
            for g in staged.grids.values():
                for x in (*tree_leaves(g.value), g.valid):
                    x.record_stream(cur)
        return staged.grids

    def _block(self, out):
        """Wait for ``out`` to be computed: an event wait on the compute
        stream (nothing is read from the card)."""
        if self._side is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
        return out

    def _observe(self, dt: float) -> None:
        if self.metrics.on:
            self._m_call.observe(dt)
            if not self._first_done:
                self._first_done = True
                self._m_first.set(time.perf_counter() - self._t_created)

    def step(self, chunks: Dict[str, SnapshotGrid], *, block: bool = True):
        """Serve one chunk (single-shot path: no lookahead to overlap)."""
        t0 = time.perf_counter()
        out = self.runner.step(self._ready(self._put(chunks)))
        if block:
            self._block(out)
        self._observe(time.perf_counter() - t0)
        return out

    def serve(self, chunk_source: Iterable[Dict[str, SnapshotGrid]], *,
              block: bool = True):
        """Generator over results, double-buffered: chunk k+1's copy to
        the card is issued before chunk k's step, so it overlaps chunk k's
        compute (and the caller's use of its result).  With ``block``
        (default) each yield is a completed result and
        ``serve.call_seconds`` measures end-to-end latency; ``block=False``
        pipelines dispatch-deep and the caller owns synchronization."""
        it = iter(chunk_source)
        try:
            cur = self._put(next(it))
        except StopIteration:
            return
        live = True
        while live:
            try:
                nxt = self._put(next(it))   # k+1's copy overlaps k's step
            except StopIteration:
                nxt, live = None, False
            t0 = time.perf_counter()
            out = self.runner.step(self._ready(cur))
            if block:
                self._block(out)
            self._observe(time.perf_counter() - t0)
            yield out
            cur = nxt

    # -- event path ----------------------------------------------------------
    def attach_events(self, *, lateness: int, policy: str = "revise",
                      capacity: int = 1024, shed: str = "newest",
                      horizon_chunks: Optional[int] = None,
                      watermark_keys=None) -> None:
        """Wire the event front end: a bounded admission ring feeding a
        disorder-tolerant :class:`IngestRunner` whose sealed rasters are
        host grids, staged to the card by the same copy as requests (the
        next sealed chunk's copy is issued before the current one's step,
        which waits for its own copy only).  ``watermark_keys`` declares
        the watermark's key universe, as in :class:`IngestRunner`.  With
        ``policy="revise"`` the runner gains revision steps: call
        :meth:`warm` again to capture them ahead of the first late
        event."""
        self.ring = AdmissionRing(capacity, shed=shed, metrics=self.metrics)
        self.ingest = IngestRunner(
            self.runner, lateness=lateness, policy=policy,
            horizon_chunks=horizon_chunks, watermark_keys=watermark_keys,
            stage=self._put, ready=self._ready, device="cpu")

    def _need_events(self):
        if self.ingest is None:
            raise RuntimeError(
                "event path not attached (call attach_events first)")

    def offer(self, name: str, ev, key: int = 0) -> bool:
        """Admit one event into the ring (False = shed)."""
        self._need_events()
        return self.ring.offer(name, ev, key=key)

    def heartbeat(self, t: int) -> None:
        self._need_events()
        self.ingest.heartbeat(t)

    def _observe_sealed(self, sealed) -> None:
        if not sealed or not self.metrics.on:
            return
        now = time.perf_counter()
        for sc in sealed:
            for t in self._admits.pop(sc.chunk, ()):
                self._m_admit.observe(now - t)

    def _drain(self, max_events: Optional[int] = None) -> None:
        span = self.ingest.chunk_span
        for e in self.ring.drain(max_events):
            self.ingest.push(e.name, e.event, key=e.key)
            self._admits.setdefault(
                (e.event.end - 1) // span, []).append(e.t_admit)

    def pump(self, max_events: Optional[int] = None) -> tuple:
        """Drain the ring into the ingest front end (FIFO) and seal +
        execute every watermark-passed chunk.  Returns
        ``(sealed, corrections)`` like :meth:`IngestRunner.poll`."""
        self._need_events()
        self._drain(max_events)
        sealed, corrections = self.ingest.poll()
        self._observe_sealed(sealed)
        return sealed, corrections

    def finish(self) -> tuple:
        """End of stream: drain everything, flush the ingest front end."""
        self._need_events()
        self._drain()
        sealed, corrections = self.ingest.flush()
        self._observe_sealed(sealed)
        return sealed, corrections


def build_service(query, *, out_len: int,
                  policy: Optional[ExecPolicy] = None,
                  n_keys: Optional[int] = None, segs_per_chunk: int = 1,
                  cache_dir: Optional[str] = None,
                  metrics: Optional[Metrics] = None,
                  device=None) -> ServeLoop:
    """Build a warmed :class:`ServeLoop` for one query on ``device`` (CUDA
    unless ``"cpu"`` is asked for).

    With ``cache_dir`` the two persisted caches live under it:
    ``plans.pkl`` (plan artifacts by structural fingerprint — the
    cross-session :class:`SharedPlanCache`) and ``aot/`` (capture
    manifests).  First process: compile, plan, capture, persist.  Fresh
    process, warm caches: the runner is rebuilt from the plan artifact (no
    planning) with its hold seeds sized from the manifest (no evaluation
    of the body), and its graphs are captured — ``loop.plan_source ==
    "warm"``.  Any cache miss falls back to the cold path transparently.
    """
    node = getattr(query, "node", query)
    policy = policy if policy is not None else ExecPolicy(body="sparse")
    if policy.union:
        raise NotImplementedError(
            "build_service serves solo queries; build a union BodySpec "
            "runner and wrap it in ServeLoop directly")
    dev = resolve(device)
    plan_cache = SharedPlanCache(
        persist=os.path.join(cache_dir, "plans.pkl") if cache_dir else None)
    exec_cache = (ExecutableCache(os.path.join(cache_dir, "aot"))
                  if cache_dir else None)
    root = plan_cache.intern(node)
    fp = ir.fingerprint(root)

    runner, how = None, "cold"
    art = plan_cache.plan_artifact(fp, out_len)
    if (art is not None and exec_cache is not None and art.get("solo")
            and (not policy.sparse or art["change_plan"] is not None)):
        spec = body_spec_from_artifact(art, root)
        if spec is not None:
            r = Runner(spec, policy, n_keys=n_keys,
                       segs_per_chunk=segs_per_chunk, metrics=metrics)
            keys = r.aot_keys()
            manifests = [exec_cache.load(step_fingerprint(r, label,
                                                          query_fp=fp))
                         for label, _ in keys]
            if all(manifest_fits(m, r, key)
                   for m, (_, key) in zip(manifests, keys)):
                r.prime_seed_shapes(manifests[0]["seed_shapes"])
                runner, how = r, "warm"
    if runner is None:
        exe = qc.compile_query(root, out_len=out_len, sparse=policy.sparse)
        runner = Runner(exe, policy, n_keys=n_keys,
                        segs_per_chunk=segs_per_chunk, metrics=metrics)
        plan_cache.store_artifact(fp, out_len, plan_artifact_of(runner))

    loop = ServeLoop(runner, exec_cache=exec_cache, query_fp=fp, device=dev)
    loop.plan_source = how
    loop.warm()
    return loop
