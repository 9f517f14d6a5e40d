"""One chunked runner for the local execution policies (body × keys); port
of ``repro.engine.runner``.

:class:`Runner` concatenates carried halo tails with the fresh chunk,
evaluates the planned partition body over the chunk's segments, slices new
tails off the buffer, advances a stream clock and checkpoints it all,
under an :class:`repro_torch.engine.policy.ExecPolicy` at
``placement="local"``.

Execution model (one ``step`` = one chunk):

* The chunk timeline is cut into ``segs_per_chunk`` **segments** of
  ``out_len`` output ticks each (one planned partition per segment).  Work
  units are ``keys × segments``; a dense body computes every unit, a sparse
  body only the units whose dilated input lineage saw a change
  (:class:`repro_torch.core.plan.ChangePlan`), the rest *hold* their
  previous output (see :mod:`repro_torch.core.sparse`).
* ``keys='vmapped'`` adds a leading key axis to every grid; internally the
  runner always carries the key axis (``K=1`` for ``keys='single'``), so
  there is exactly one code path.
* Units ride the evaluator's leading axis: the unit windows are gathered
  into ``(U, L)`` grids and the compiled query runs once per chunk over
  all of them (the reference ``vmap``s the body over units instead).
* ``dag='union'`` runs the union DAG of N queries (one
  :class:`repro_torch.core.plan.UnionPlan`, see
  :func:`repro_torch.multiquery.union_runner`) and returns one grid per
  query; the merged :class:`~repro_torch.core.plan.ChangePlan` of the union
  is the per-input union of the per-query dilations, so the sparse body
  composes with multi-query sharing.
* Late data: with :meth:`Runner.enable_revision` the runner keeps the
  carried tails of its last chunks, and :meth:`Runner.revise` re-runs
  sealed chunks on patched inputs, computing only the segments the late
  change can reach (the compacted body, never a dense replay).

The sparse body reads the chunk's dirty-unit count once (4 bytes,
device→host) to pick the compaction bucket on the host — the port's one
synchronizing call per sparse chunk; everything else a steady-state chunk
does, the telemetry included, stays on the device.  State is not donated:
each chunk makes new tensors for the carried state, and :meth:`state` /
:meth:`restore` copy out and in.

State pytree (the *only* cross-chunk state, host-roundtrippable through
:meth:`Runner.state` / :meth:`Runner.restore` with one validation path)::

    { input_name: (value_tail, valid_tail),   # trailing left_halo ticks
      "__t": int,                             # stream clock
      "__sparse": {                           # body='sparse' only
         "dirty": {input_name: dirty_tail},   # change flags for those ticks
         "prev":  {input_name: 1-tick snapshot},  # halo-free inputs only
         "seed":  {out_name: last output tick},   # hold seed per output
         "started": bool } }

Time is the last axis of every tensor: a tail is ``(K, left_halo)`` (value
leaves may carry channel axes between the key axis and time).

Not ported yet, and raising ``NotImplementedError`` naming their ROADMAP
item: AOT serving (A13), the static-audit surface (A15); mesh placement is
refused by :class:`ExecPolicy` (A14).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..core import ir
from ..core import sparse as sparse_mod
from ..core.plan import ChangePlan, InputSpec, seg_range_affine
from ..core.stream import SnapshotGrid
from ..kernels import sparse_compact
from ..obs import Metrics, log_buckets
from .policy import ExecPolicy

__all__ = ["BodySpec", "Runner", "body_spec_of"]

_tm = tree_map


@dataclasses.dataclass
class BodySpec:
    """Everything the runner needs to know about a per-segment body.

    A body evaluates one planned partition: given ``{input_name: (value,
    valid)}`` grids covering one segment plus halo (``input_specs``), with
    any number of units on a leading axis, it returns ``{out_name: (value,
    valid)}`` output grids of ``span // out_precs[name]`` ticks per unit.
    Solo queries are the single-output case (``out_name == "__out"``);
    union DAGs return one entry per query.

    ``step_cache`` holds the built chunk steps, keyed by execution
    geometry and device — share it across Runner instances over the same
    compiled query so fresh runners reuse them.
    """

    input_specs: Dict[str, InputSpec]
    out_len: int     # segment length in ticks of the reference output grid
    out_prec: int
    outs_fn: Callable[[Dict[str, tuple]], Dict[str, tuple]]
    out_precs: Dict[str, int]
    change_plan: Optional[ChangePlan] = None
    root: Optional[ir.Node] = None
    solo: bool = True
    step_cache: dict = dataclasses.field(default_factory=dict)

    @property
    def span(self) -> int:
        return self.out_len * self.out_prec


def body_spec_of(exe) -> BodySpec:
    """The :class:`BodySpec` of a :class:`repro_torch.core.compile.
    CompiledQuery` (the ``dag='solo'`` case).  The step cache lives on the
    CompiledQuery, so every Runner over the same executable shares built
    steps."""

    def outs_fn(inputs: Dict[str, tuple]) -> Dict[str, tuple]:
        return {"__out": exe.fn(inputs)}

    return BodySpec(
        input_specs=exe.input_specs, out_len=exe.out_len,
        out_prec=exe.out_prec, outs_fn=outs_fn,
        out_precs={"__out": exe.out_prec},
        change_plan=exe.change_plan, root=exe.root, solo=True,
        step_cache=exe.__dict__.setdefault("_runner_step_cache", {}))


def _bc(mask, x):
    """Broadcast a leading-axes mask over the trailing dims of ``x``."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def _cat(a, b):
    return torch.cat([a, b], dim=-1)


def _windows(x: torch.Tensor, length: int, core: int) -> torch.Tensor:
    """Segment ``k``'s halo window of a ``(K, ..., T)`` buffer is ticks
    ``[k·core, k·core + length)``: a ``(K, n_segs, ..., length)`` view."""
    return x.unfold(-1, length, core).movedim(-2, 1)


def _ticks(x: torch.Tensor, n_segs: int) -> torch.Tensor:
    """``(K, n_segs, ..., S)`` per-segment outputs → ``(K, ..., n_segs·S)``."""
    x = x.movedim(1, -2)
    return x.reshape(x.shape[:-2] + (-1,))


def _any_rows(neq: torch.Tensor) -> torch.Tensor:
    """OR a ``(K, ..., n)`` flag tensor over its channel axes → ``(K, n)``."""
    return neq.reshape(neq.shape[0], -1, neq.shape[-1]).any(dim=1)


class Runner:
    """Chunked streaming execution under one :class:`ExecPolicy`.

    Parameters
    ----------
    exe_or_spec:
        A :class:`~repro_torch.core.compile.CompiledQuery` (``dag='solo'``;
        pass ``sparse=True`` to :func:`~repro_torch.core.compile.
        compile_query` for a sparse body) or a prebuilt :class:`BodySpec`
        (the union path: see :func:`repro_torch.multiquery.union_runner`).
    policy:
        The execution policy.  ``keys='vmapped'`` requires ``n_keys``.
    segs_per_chunk:
        Segments consumed per :meth:`step`; each chunk supplies
        ``segs_per_chunk · spec.core`` fresh ticks per input.
    metrics:
        A :class:`repro_torch.obs.Metrics` registry to accumulate runtime
        telemetry into (``runner.*`` metric names).  Default: a fresh
        private registry on ``self.metrics``.

    The runner runs on the device of the chunks it is given; restored
    state moves there at the next step.
    """

    def __init__(self, exe_or_spec, policy: ExecPolicy = ExecPolicy(), *,
                 n_keys: Optional[int] = None, segs_per_chunk: int = 1,
                 metrics: Optional[Metrics] = None):
        spec = (exe_or_spec if isinstance(exe_or_spec, BodySpec)
                else body_spec_of(exe_or_spec))
        if policy.union != (not spec.solo):
            raise ValueError(
                f"policy dag={policy.dag!r} does not match the body "
                f"(solo={spec.solo}); union runners need a union BodySpec "
                "(see repro_torch.multiquery.union_runner)")
        if segs_per_chunk < 1:
            raise ValueError("segs_per_chunk must be >= 1")
        self.spec, self.policy = spec, policy
        self.n_segs = segs_per_chunk
        if policy.keyed:
            if n_keys is None:
                raise ValueError("keys='vmapped' needs n_keys")
            self.n_keys = n_keys
        else:
            if n_keys not in (None, 1):
                raise ValueError(
                    f"keys='single' runs one stream (got n_keys={n_keys}); "
                    "use ExecPolicy(keys='vmapped') for keyed sub-streams")
            self.n_keys = 1

        span = spec.span
        for name, s in spec.input_specs.items():
            if s.right_halo > 0:
                raise NotImplementedError(
                    "chunked runners support lookback-only queries "
                    f"(input {name} has lookahead)")
            if s.core * s.prec != span:
                raise ValueError(
                    f"input {name}: segment span {span} not a multiple of "
                    f"input precision {s.prec}")
        if policy.sparse and spec.change_plan is None:
            raise ValueError(
                "ExecPolicy(body='sparse') needs a query compiled with "
                "sparse=True (no ChangePlan attached)")
        if spec.root is not None and policy.keyed:
            keyed_inputs = [n.name for n in ir.free_inputs(spec.root)
                            if n.keyed]
            if keyed_inputs and set(keyed_inputs) != set(spec.input_specs):
                raise ValueError(
                    "query mixes keyed and unkeyed sources: "
                    f"keyed={keyed_inputs}, all={sorted(spec.input_specs)}")

        # -- the state pytree -----------------------------------------------
        self._tails: Dict[str, tuple] = {}
        self._sparse: Optional[dict] = (
            {"dirty": {}, "prev": {}, "seed": {}, "started": False}
            if policy.sparse else None)
        self._t = 0
        self._device: Optional[torch.device] = None
        self._zero_seed_cache = None
        # -- sparse-body diagnostics (device-resident: reading them via
        # dirty_stats() syncs, accumulating them does not) ------------------
        self.last_seg_dirty = None
        self._dirty_units = None
        self._total_units = 0
        self._chunks_run = 0
        self._mstate = None  # (dirty_total, bucket_picks, frac_counts)
        # -- late-data revision ring (off unless enable_revision) -----------
        self._rev_ring: Optional[collections.deque] = None
        self.revision_horizon = 0
        self._obs_init(metrics)

    # -- telemetry -----------------------------------------------------------
    def _obs_init(self, metrics: Optional[Metrics]) -> None:
        """Create/bind the runner's metric handles.  Device-resident
        metrics hold references into ``self._mstate``, the per-runner
        device accumulators updated in place once per sparse chunk
        (:meth:`_obs_sparse_chunk`); host metrics are plain Python
        arithmetic."""
        self.metrics = m = metrics if metrics is not None else Metrics()
        self._m_chunks = m.counter(
            "runner.chunks", "chunks stepped", "chunks")
        self._m_units = m.counter(
            "runner.units", "work units (keys x segments) presented",
            "units")
        self._m_keys = m.gauge("runner.keys", "keyed sub-streams", "keys")
        self._m_keys.set(self.n_keys)
        self._m_lat = m.histogram(
            "runner.step_seconds", log_buckets(1e-5, 10.0, per_decade=3),
            "per-chunk step wall time (dispatch, not device completion)",
            "s", log_scale=True)
        self._m_rev_runs = m.counter(
            "runner.revision_runs", "late-data revision re-runs", "runs")
        self._m_rev_chunks = m.counter(
            "runner.revision_chunks",
            "sealed chunks re-stepped by revisions", "chunks")
        self._m_rev_units = m.counter(
            "runner.revision_units",
            "work units recomputed by revisions (ChangePlan-dilated dirty "
            "segments only)", "units")
        # device-resident handles: fold any previous owner's device refs
        # into the host base before this runner's mstate takes over
        self._m_dirty = m.counter(
            "runner.dirty_units", "work units that actually computed",
            "units")
        self._m_dirty.fold_device()
        ladder = (sparse_mod.capacity_ladder(self._U)
                  if self.policy.sparse else [])
        self._obs_caps = np.asarray(ladder, np.int32)
        if ladder:
            labels = [str(c) for c in ladder]
            prior = m.get("runner.bucket_picks")
            if prior is not None and prior.labels != labels:
                # a rebuilt runner at a new geometry has a new ladder —
                # the old slots don't mean anything anymore
                m.drop("runner.bucket_picks")
            self._m_picks = m.vector(
                "runner.bucket_picks", labels,
                "capacity-bucket selections (slot = capacity)", "picks")
            self._m_picks.fold_device()
        else:
            self._m_picks = None
        self._obs_frac_edges = np.linspace(1 / 16, 1.0, 16)
        self._m_frac = m.histogram(
            "runner.dirty_fraction", [round(float(e), 6)
                                      for e in self._obs_frac_edges],
            "per-chunk dirty work-unit fraction", "fraction")
        self._m_frac.fold_device()
        m.register_collector("runner", self._obs_collect)
        m.register_warmup_reset("runner", self._obs_warmup_reset)

    def _new_mstate(self, dev: torch.device):
        z = lambda *shape: torch.zeros(shape, dtype=torch.int32,  # noqa: E731
                                       device=dev)
        return (z(), z(len(self._obs_caps)),
                z(len(self._obs_frac_edges) + 1))

    def _obs_warmup_reset(self) -> None:
        """Registry warmup-reset hook (:meth:`repro_torch.obs.Metrics.
        reset_after_warmup`): re-base this runner's device accumulators and
        compaction window; the stream state itself is untouched.  The fresh
        accumulators are made here (off the hot path), on the runner's
        device once it has one."""
        if self.policy.sparse and self._device is not None:
            self._mstate = self._new_mstate(self._device)
        else:
            self._mstate = None
        self._dirty_units = None
        self._total_units = 0
        self._chunks_run = 0
        self._m_keys.set(self.n_keys)

    def _obs_collect(self) -> None:
        """Pre-snapshot hook: derived gauges (syncs — off the hot path)."""
        stats = self.dirty_stats()
        if stats is not None:
            self.metrics.gauge("runner.compact",
                               "dirty fraction since construction/reset",
                               "fraction").set(stats["compact"])

    def _obs_accum(self, dev: torch.device):
        """The per-chunk device metric accumulator: folds the chunk's
        dirty count into the running total, the bucket-pick counts and the
        dirty-fraction histogram, in place, with ``searchsorted`` and
        ``scatter_add_`` — no host read, no bincount, no mask indexing."""
        key = self._cache_key("obs_accum", dev)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        caps = torch.as_tensor(self._obs_caps, device=dev)
        edges = torch.as_tensor(self._obs_frac_edges, dtype=torch.float32,
                                device=dev)
        one = torch.ones(1, dtype=torch.int32, device=dev)
        U = self._U

        def accum(mstate, cnt):
            total, picks, frac = mstate
            b = torch.clamp(torch.searchsorted(caps, cnt.reshape(1)), 0,
                            len(self._obs_caps) - 1)
            fi = torch.searchsorted(edges, cnt.reshape(1).float() / U)
            total.add_(cnt)
            picks.scatter_add_(0, b, one)
            frac.scatter_add_(0, fi, one)

        cache[key] = accum
        return accum

    def _obs_sparse_chunk(self, cnt: torch.Tensor) -> None:
        """Per-sparse-chunk device metric update: in-place accumulator
        launches plus reference re-binds — no device→host transfer."""
        if self._mstate is None:
            self._mstate = self._new_mstate(cnt.device)
        self._obs_accum(cnt.device)(self._mstate, cnt)
        total, picks, frac = self._mstate
        self._m_dirty.set_device(total)
        self._m_picks.set_device(picks)
        self._m_frac.set_device(frac)
        # dirty_stats() reads the same accumulator (runner-local view)
        self._dirty_units = total

    # -- geometry ------------------------------------------------------------
    @property
    def _K(self) -> int:
        return self.n_keys

    @property
    def _U(self) -> int:
        return self.n_keys * self.n_segs

    def _names(self):
        return sorted(self.spec.input_specs)

    def _cache_key(self, kind, dev, *extra):
        """Step-cache key: the geometry the built steps close over, the
        device their index tensors live on, then ``extra`` (the capacity
        of a compute step last)."""
        return (kind, self._K, self.n_segs, str(dev)) + extra

    def _compile_label(self, key) -> str:
        """The recompile detector's unit of accounting (device-free, as
        the reference's labels)."""
        kind, K, n_segs = key[0], key[1], key[2]
        parts = [f"K={K}", f"segs={n_segs}"] + [str(x) for x in key[4:]]
        return f"{kind}({','.join(parts)})"

    # -- chunk ingest --------------------------------------------------------
    def _ingest(self, chunks: Dict[str, SnapshotGrid]) -> Dict[str, tuple]:
        chunk_in = {}
        for name in self._names():
            s = self.spec.input_specs[name]
            g = chunks[name]
            want = ((self.n_keys, s.core * self.n_segs) if self.policy.keyed
                    else (s.core * self.n_segs,))
            if tuple(g.valid.shape) != want:
                raise ValueError(
                    f"input {name}: chunk validity shape "
                    f"{tuple(g.valid.shape)} != expected {want}")
            v, m = g.value, g.valid
            if not self.policy.keyed:  # internal layout always carries K
                v, m = _tm(lambda x: x[None], v), m[None]
            chunk_in[name] = (v, m)
        return chunk_in

    def _chunk_device(self, chunk_in) -> torch.device:
        for _, m in chunk_in.values():
            return m.device
        return self._device or torch.device("cpu")

    def _move_state(self, dev: torch.device) -> None:
        """Put the carried state on ``dev`` (a restore, or the first chunk
        on another device) — off the steady path."""
        to = lambda t: _tm(lambda x: x.to(dev), t)  # noqa: E731
        self._tails = {k: to(v) for k, v in self._tails.items()}
        if self._sparse is not None:
            st = self._sparse
            for part in ("dirty", "prev", "seed"):
                st[part] = {k: to(v) for k, v in st[part].items()}
        if self._mstate is not None:
            self._mstate = tuple(x.to(dev) for x in self._mstate)
        self._dirty_units = (None if self._dirty_units is None
                             else self._dirty_units.to(dev))
        self._zero_seed_cache = None
        self._device = dev

    def _init_missing_tails(self, chunk_in: Dict[str, tuple]) -> None:
        K = self._K
        for name in self._names():
            if name in self._tails:
                continue
            hl = self.spec.input_specs[name].left_halo
            cv, cm = chunk_in[name]
            dev = cm.device
            tv = _tm(lambda x: torch.zeros(x.shape[:-1] + (hl,),
                                           dtype=x.dtype, device=dev), cv)
            self._tails[name] = (tv, torch.zeros((K, hl), dtype=torch.bool,
                                                 device=dev))
            if self._sparse is not None and name not in self._sparse["dirty"]:
                self._sparse["dirty"][name] = torch.zeros(
                    (K, hl), dtype=torch.bool, device=dev)
                if hl == 0:
                    # the 1-tick snapshot is only ever read for halo-free
                    # inputs (tick 0's diff partner); halo-carrying inputs
                    # get their position-0 flag from the dirty tail
                    self._sparse["prev"][name] = (
                        _tm(lambda x: torch.zeros(x.shape[:-1] + (1,),
                                                  dtype=x.dtype, device=dev),
                            cv),
                        torch.zeros((K, 1), dtype=torch.bool, device=dev))

    def _new_tails(self, bufs) -> Dict[str, tuple]:
        """The trailing ``left_halo`` ticks of every buffer (copies, so the
        chunk buffers are not kept alive)."""
        out = {}
        for name, (fv, fm) in bufs.items():
            s = self.spec.input_specs[name]
            lo = s.core * self.n_segs
            hl = s.left_halo
            out[name] = (_tm(lambda x: x[..., lo:lo + hl].clone(), fv),
                         fm[..., lo:lo + hl].clone())
        return out

    def _units(self, bufs, ids=None):
        """Unit windows of every input, units on the leading axis: all
        ``U`` units (``ids=None``, unit ``u = key·n_segs + segment``) or
        the ones named by ``ids``."""
        specs, n_segs = self.spec.input_specs, self.n_segs
        out = {}
        for name, (fv, fm) in bufs.items():
            L, core = specs[name].length, specs[name].core
            if ids is None:
                def take(x, L=L, core=core):
                    w = _windows(x, L, core)
                    return w.reshape((-1,) + w.shape[2:])
            else:
                k_ids, s_ids = ids // n_segs, ids % n_segs

                def take(x, L=L, core=core, k_ids=k_ids, s_ids=s_ids):
                    return _windows(x, L, core)[k_ids, s_ids]
            out[name] = (_tm(take, fv), take(fm))
        return out

    # -- dense step ----------------------------------------------------------
    def _dense_step(self, dev: torch.device):
        key = self._cache_key("dense", dev)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        names, outs_fn = self._names(), self.spec.outs_fn
        K, n_segs = self._K, self.n_segs

        def step(tails, chunks):
            bufs = {}
            for name in names:
                tv, tm = tails[name]
                cv, cm = chunks[name]
                bufs[name] = (_tm(_cat, tv, cv), _cat(tm, cm))
            outs = outs_fn(self._units(bufs))
            outs = {o: (_tm(lambda x: _ticks(x.reshape(
                            (K, n_segs) + x.shape[1:]), n_segs), ov),
                        om.reshape(K, -1))
                    for o, (ov, om) in outs.items()}
            return outs, self._new_tails(bufs)

        cache[key] = step
        return step

    # -- sparse body -----------------------------------------------------------
    #
    # One step per chunk: mask (fused change detection + carried flags),
    # the one host read of the dirty count, the bucket's compacted compute,
    # the hold fill.

    def _compute_local(self, cap: int, dev: torch.device):
        """Compute body for one compaction capacity: resolve the dirty
        units into ``cap`` fixed-size ids without a host read, gather their
        halo windows, evaluate them only, scatter the results back over
        the unit axis.  Built on first use of each capacity."""
        key = self._cache_key("compute", dev, cap)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        outs_fn = self.spec.outs_fn

        if cap == self._U:
            # full-capacity bucket (count > U/2): compaction saves nothing,
            # so compute every unit in place.  Bit-identical: computing a
            # clean unit yields exactly its hold value (the sparse
            # exactness contract), and the hold fill downstream still
            # overwrites clean units from the dirty chain.
            def local(w, bufs):
                return outs_fn(self._units(bufs))
        else:
            def local(w, bufs):
                ids, pos = sparse_mod.compact_ids(w, cap)
                outs = outs_fn(self._units(bufs, ids))      # (cap, ..., S)
                return {o: (_tm(lambda x: x.index_select(0, pos), ov),
                            om.index_select(0, pos))
                        for o, (ov, om) in outs.items()}    # (U, ..., S)

        cache[key] = local
        return local

    def _hold(self, full_outs, seg_dirty, seeds, ar):
        """Hold fill: clean units take the last tick of the nearest
        preceding dirty segment of the same key, or the key's carried hold
        seed; dirty units keep their computed results."""
        K, n_segs = self._K, self.n_segs
        prev_d = torch.cummax(torch.where(seg_dirty, ar[None, :], -1),
                              dim=1).values
        src = torch.clamp(prev_d, 0, n_segs - 1)            # (K, n_segs)
        has = prev_d >= 0

        def take_seg(x):                   # x (K, n_segs, ...) at src
            idx = src.reshape(src.shape + (1,) * (x.dim() - 2))
            return torch.gather(x, 1, idx.expand_as(x))

        outs, new_seeds = {}, {}
        for o, (fv, fm) in full_outs.items():       # fv (K, n_segs, ..., S)
            sv, sm = seeds[o]

            def hold_leaf(x, seed):
                hx = take_seg(x[..., -1])            # (K, n_segs, ...)
                hx = torch.where(_bc(has, hx), hx,
                                 seed.unsqueeze(1).to(x.dtype))
                return torch.where(_bc(seg_dirty, x), x, hx.unsqueeze(-1))

            ov = _tm(lambda x: _ticks(x, n_segs), _tm(hold_leaf, fv, sv))
            hm = torch.where(has, take_seg(fm[..., -1]), sm[:, None])
            om = torch.where(seg_dirty[:, :, None], fm,
                             hm[:, :, None]).reshape(K, -1)
            outs[o] = (ov, om)
            new_seeds[o] = (_tm(lambda x: x[..., -1], ov), om[:, -1])
        return outs, new_seeds

    def _sparse_step(self, force_first: bool, dev: torch.device):
        """The whole sparse chunk: mask → host bucket pick → compacted
        compute → hold.

        ``step(tails, dirty, prev, seeds, chunks)`` returns ``(outs,
        new_tails, new_dirty, new_prev, new_seeds, seg_dirty, cnt)``, with
        ``cnt`` the device count of dirty units.  Two variants per
        geometry: ``force_first=True`` (stream start / missing hold seed:
        segment 0 of every key is forced dirty) and the steady state.
        """
        key = self._cache_key("sparse_fused", dev, force_first)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        names, specs = self._names(), self.spec.input_specs
        cp = self.spec.change_plan
        S, q = self.spec.out_len, self.spec.out_prec
        K, n_segs, U = self._K, self.n_segs, self._U

        # static per-input lineage geometry (the ChangePlan lowered to the
        # affine form the kernel consumes) + the segments a carried
        # position-0 change flag dirties (tick 0 is outside the kernel's
        # convention: its diff partner lives before the buffer)
        geom, hits0 = {}, {}
        ks = np.arange(n_segs)
        for name in names:
            s, sp = specs[name], cp.specs[name]
            a0, stp, width = seg_range_affine(
                sp.lookback, sp.lookahead, s.prec,
                grid_t0=-s.left_halo * s.prec, out_t0=0, out_prec=q,
                seg_len=S)
            geom[name] = (a0, stp, width)
            lo = a0 + ks * stp
            hits0[name] = torch.as_tensor((lo <= 0) & (lo + width > 0),
                                          device=dev)
        ar = torch.arange(n_segs, device=dev)

        def tick0_diff(cv, cm, pv, pm):
            d = cm[:, 0] != pm[:, 0]
            for x, p in zip(tree_leaves(cv), tree_leaves(pv)):
                neq = x[..., :1] != p.to(x.dtype)
                d = d | _any_rows(neq)[:, 0]
            return d

        def adj_diff(sv, sm):
            nd = sm[:, 1:] != sm[:, :-1]
            for x in tree_leaves(sv):
                nd = nd | _any_rows(x[..., 1:] != x[..., :-1])
            return nd

        def step(tails, dirty, prev, seeds, chunks):
            bufs, new_dirty, new_prev = {}, {}, {}
            seg_dirty = torch.zeros((K, n_segs), dtype=torch.bool,
                                    device=dev)
            for name in names:
                s = specs[name]
                hl = s.left_halo
                tv, tm = tails[name]
                cv, cm = chunks[name]
                fv, fm = _tm(_cat, tv, cv), _cat(tm, cm)
                bufs[name] = (fv, fm)
                mats = sparse_compact.grid_mats(fv, fm)
                sd = sparse_compact.seg_dirty(mats, [geom[name]] * len(mats),
                                              n_segs)           # (K, n_segs)
                # buffer position 0: carried change flag (its diff partner
                # is one tick before the buffer); with no tail the carried
                # 1-tick snapshot supplies the partner
                d0 = (dirty[name][:, 0] if hl
                      else tick0_diff(cv, cm, *prev[name]))
                seg_dirty = seg_dirty | sd | (d0[:, None] & hits0[name])
                lo = s.core * n_segs
                if hl:
                    # carried dirty tail = adjacent diffs of the buffer's
                    # last hl+1 ticks (every tail position has its diff
                    # partner in the buffer, since lo >= 1)
                    new_dirty[name] = adj_diff(
                        _tm(lambda x: x[..., lo - 1:lo + hl], fv),
                        fm[..., lo - 1:lo + hl])
                else:
                    new_dirty[name] = dirty[name]
                    new_prev[name] = (_tm(lambda x: x[..., -1:].clone(), cv),
                                      cm[:, -1:].clone())
            if not names:
                seg_dirty = torch.ones((K, n_segs), dtype=torch.bool,
                                       device=dev)      # input-free: dense
            if force_first:
                seg_dirty[:, 0] = True
            w = seg_dirty.reshape(U)
            cnt = w.sum(dtype=torch.int32)
            # the one synchronizing call of a sparse chunk: the 4-byte
            # dirty count picks the compaction bucket on the host
            cap = sparse_mod.bucket_capacity(int(cnt), U)
            full = self._compute_local(cap, dev)(w, bufs)
            full = {o: (_tm(lambda x: x.reshape((K, n_segs) + x.shape[1:]),
                            fv),
                        fm.reshape((K, n_segs) + fm.shape[1:]))
                    for o, (fv, fm) in full.items()}
            outs, new_seeds = self._hold(full, seg_dirty, seeds, ar)
            return (outs, self._new_tails(bufs), new_dirty, new_prev,
                    new_seeds, seg_dirty, cnt)

        cache[key] = step
        return step

    def _zero_seeds(self, chunk_in):
        """φ hold seeds shaped like one output tick per key (unread: any
        output missing a carried seed forces its first segment dirty).
        The shapes come from evaluating the body once on a zero input of
        one unit, on the runner's device."""
        if self._zero_seed_cache is not None:
            return self._zero_seed_cache
        zeros = {}
        for name in self._names():
            L = self.spec.input_specs[name].length
            cv, cm = chunk_in[name]
            zeros[name] = (
                _tm(lambda x: torch.zeros((1,) + x.shape[1:-1] + (L,),
                                          dtype=x.dtype, device=x.device),
                    cv),
                torch.zeros((1, L), dtype=torch.bool, device=cm.device))
        outs = self.spec.outs_fn(zeros)
        K = self._K
        self._zero_seed_cache = {
            o: (_tm(lambda a: torch.zeros((K,) + a.shape[1:-1],
                                          dtype=a.dtype, device=a.device),
                    ov),
                torch.zeros((K,), dtype=torch.bool, device=om.device))
            for o, (ov, om) in outs.items()}
        return self._zero_seed_cache

    def _sparse_chunk(self, chunk_in, dev):
        st = self._sparse
        missing_seed = any(o not in st["seed"] for o in self.spec.out_precs)
        force_first = (not st["started"]) or missing_seed
        if force_first:
            seeds = dict(self._zero_seeds(chunk_in))
            seeds.update(st["seed"])
        else:
            seeds = st["seed"]
        (outs, new_tails, new_dirty, new_prev, new_seeds, seg_dirty,
         cnt) = self._sparse_step(force_first, dev)(
            self._tails, st["dirty"], st["prev"], seeds, chunk_in)
        self.last_seg_dirty = seg_dirty
        if self.metrics.on:
            self._obs_sparse_chunk(cnt)
        else:
            self._dirty_units = (cnt if self._dirty_units is None
                                 else self._dirty_units + cnt)
        self._total_units += self._U
        self._chunks_run += 1

        def commit():
            self._tails = new_tails
            st["dirty"], st["prev"] = new_dirty, new_prev
            st["seed"], st["started"] = new_seeds, True

        return outs, commit

    def _postprocess(self, outs):
        """Drop the internal K axis for single-key runners (a view)."""
        if self.policy.keyed:
            return outs
        return {o: (_tm(lambda x: x[0], v), m[0])
                for o, (v, m) in outs.items()}

    # -- public API ----------------------------------------------------------
    def step(self, chunks: Dict[str, SnapshotGrid]):
        """Advance the stream by one chunk (``segs_per_chunk`` segments).

        Each chunk grid supplies ``segs_per_chunk · spec.core`` fresh ticks
        per input (leading key axis first when ``keys='vmapped'``).
        Returns one output grid (solo) or ``{query_name: grid}`` (union).
        Carried state commits only after the step succeeded, so a raise
        leaves the runner exactly as it was.
        """
        t0 = time.perf_counter()
        chunk_in = self._ingest(chunks)
        dev = self._chunk_device(chunk_in)
        if dev != self._device:
            self._move_state(dev)
        self._init_missing_tails(chunk_in)
        snap = None
        if self._rev_ring is not None:
            # pre-chunk tails for the revision ring: references, not
            # copies — nothing updates carried tensors in place (each
            # chunk makes new ones), so revisability costs no transfer
            snap = {"chunk": self._t // (self.n_segs * self.spec.span),
                    "tails": dict(self._tails)}
        if self.policy.sparse:
            outs, commit = self._sparse_chunk(chunk_in, dev)
        else:
            outs, new_tails = self._dense_step(dev)(self._tails, chunk_in)

            def commit(new_tails=new_tails):
                self._tails = new_tails

        result = {}
        for o, (v, m) in self._postprocess(outs).items():
            result[o] = SnapshotGrid(value=v, valid=m, t0=self._t,
                                     prec=self.spec.out_precs[o])
        commit()
        if snap is not None:
            self._rev_ring.append(snap)
        self._t += self.n_segs * self.spec.span
        if self.metrics.on:
            # host-side arithmetic only (perf_counter + numpy bisect):
            # wall time around the launches, never a device read
            self._m_chunks.add(1)
            self._m_units.add(self._U)
            self._m_lat.observe(time.perf_counter() - t0)
        return result["__out"] if self.spec.solo else result

    def run(self, inputs: Dict[str, SnapshotGrid], n_chunks: int):
        """Slice ``n_chunks`` chunks from full streams, step through them
        and stitch the outputs along time."""
        outs = []
        for c in range(n_chunks):
            chunk = {}
            for name in self._names():
                s = self.spec.input_specs[name]
                g = inputs[name]
                n = s.core * self.n_segs
                lo = c * n
                chunk[name] = SnapshotGrid(
                    value=_tm(lambda x: x[..., lo:lo + n], g.value),
                    valid=g.valid[..., lo:lo + n],
                    t0=g.t0 + lo * s.prec, prec=s.prec)
            outs.append(self.step(chunk))

        def stitch(parts):
            value = _tm(lambda *xs: torch.cat(xs, dim=-1),
                        *[p.value for p in parts])
            valid = torch.cat([p.valid for p in parts], dim=-1)
            return SnapshotGrid(value=value, valid=valid, t0=parts[0].t0,
                                prec=parts[0].prec)

        if self.spec.solo:
            return stitch(outs)
        return {o: stitch([c[o] for c in outs]) for o in outs[0]}

    def reset(self) -> None:
        """Drop carried state; the next step starts a fresh stream at t=0."""
        self._tails = {}
        if self._sparse is not None:
            self._sparse = {"dirty": {}, "prev": {}, "seed": {},
                            "started": False}
        self._t = 0
        self.last_seg_dirty = None
        self._dirty_units = None
        self._total_units = 0
        self._chunks_run = 0
        if self._rev_ring is not None:
            self._rev_ring.clear()
        if self._mstate is not None:
            # preserve the registry's running totals (syncs — off-path),
            # then drop this runner's device accumulator state
            self._m_dirty.fold_device()
            if self._m_picks is not None:
                self._m_picks.fold_device()
            self._m_frac.fold_device()
            self._mstate = None

    def dirty_stats(self) -> Optional[Dict]:
        """Measured compaction of the sparse body since construction/reset:
        ``{chunks, units, dirty_units, compact}`` where ``compact`` is the
        fraction of (key × segment) work units that actually computed
        (forced-dirty first segments included).  ``None`` for dense bodies
        or before the first chunk.  Reading syncs the device-resident
        counter — a diagnostic call, not part of the steady path."""
        if self._sparse is None or self._total_units == 0:
            return None
        dirty = int(self._dirty_units)
        return {"chunks": self._chunks_run, "units": self._total_units,
                "dirty_units": dirty,
                "compact": dirty / self._total_units}

    # -- checkpointing (the one state/validate path) -------------------------
    def _strip(self, tree, host: bool = True):
        """Copies (numpy on the host, or tensors where they are), without
        the internal K axis for single-key runners: nothing a later step
        does can reach them."""
        def one(x):
            x = (x.detach().to("cpu", copy=True).numpy() if host
                 else x.detach().clone())
            return x if self.policy.keyed else x[0]
        return _tm(one, tree)

    def _lift(self, tree):
        """Tensors copied in from a checkpoint's arrays or tensors (on the
        CPU until the next step puts them on the runner's device, unless
        they come as tensors on a device already)."""
        def one(x):
            t = (x.detach().clone() if torch.is_tensor(x)
                 else torch.from_numpy(np.array(x, copy=True)))
            if self._device is not None:
                t = t.to(self._device)
            return t if self.policy.keyed else t[None]
        return _tm(one, tree)

    def state(self, *, host: bool = True) -> Dict:
        """Checkpointable runner state: host numpy copies, or with
        ``host=False`` tensor copies on the runner's device (a re-fit that
        stays on the card); see the module docstring for the pytree
        layout."""
        strip = lambda t: self._strip(t, host)  # noqa: E731
        out = {k: strip(v) for k, v in self._tails.items()}
        out["__t"] = self._t
        if self._sparse is not None:
            st = self._sparse
            out["__sparse"] = {
                "dirty": {k: strip(v) for k, v in st["dirty"].items()},
                "prev": {k: strip(v) for k, v in st["prev"].items()},
                "seed": {o: strip(v) for o, v in st["seed"].items()},
                "started": st["started"]}
        return out

    def restore(self, state: Dict, *, strict: bool = True) -> None:
        """Restore a :meth:`state` checkpoint, validating it against this
        runner's configuration first.

        Every inconsistency — wrong input names, wrong key count, wrong
        tail length (a checkpoint from a different query/plan), a stream
        clock misaligned with the partition span, missing or unexpected
        sparse change state — raises a ``ValueError`` naming the mismatch.
        ``strict=False`` additionally tolerates inputs absent from the
        checkpoint (their tails re-initialize to φ).  The arrays are
        copied in.
        """
        state = dict(state)
        if "__t" not in state:
            raise ValueError("checkpoint has no '__t' stream clock")
        t = state.pop("__t")
        span = self.spec.span
        if not isinstance(t, (int, np.integer)) or t < 0 or t % span:
            raise ValueError(
                f"checkpoint stream clock __t={t!r} is not a non-negative "
                f"multiple of the partition span {span} — was this saved "
                "from an engine with a different out_len/out_prec?")
        sparse_state = state.pop("__sparse", None)
        if self.policy.sparse and sparse_state is None:
            raise ValueError(
                "sparse engine cannot restore a dense checkpoint: no "
                "'__sparse' change state (dirty tails / snapshots / seed)")
        if not self.policy.sparse and sparse_state is not None:
            raise ValueError(
                "dense engine cannot restore a sparse checkpoint "
                "(carries '__sparse' change state)")
        specs = self.spec.input_specs
        names = set(specs)
        unknown = sorted(set(state) - names)
        missing = sorted(n for n in names - set(state)
                         if specs[n].left_halo > 0) if strict else []
        if state and (unknown or missing):
            raise ValueError(
                f"checkpoint inputs {sorted(state)} != query inputs "
                f"{sorted(names)} (unknown={unknown}, missing={missing})")
        lead = ((self._K,) if self.policy.keyed else ())
        label = ("(n_keys, left_halo)" if self.policy.keyed
                 else "(left_halo,)")

        def check_lead(name, got, what):
            want = lead + (specs[name].left_halo,)
            if tuple(got) != want:
                raise ValueError(
                    f"input {name}: checkpoint {what} shape {tuple(got)} != "
                    f"{label} = {want}")

        for name, (tv, tm) in state.items():
            check_lead(name, np.shape(tm), "tail")
            for leaf in tree_leaves(tv):
                shp = tuple(np.shape(leaf))
                want = lead + (specs[name].left_halo,)
                if shp[:len(lead)] + shp[-1:] != want:
                    raise ValueError(
                        f"input {name}: checkpoint tail value leaf shape "
                        f"{shp} does not match {label} = {want} on its key "
                        "and time axes")
        if sparse_state is not None:
            for name in state:
                got = np.shape(sparse_state["dirty"].get(name, ()))
                check_lead(name, got, "dirty-tail")
            if strict:
                # halo-free inputs carry their whole change lineage in the
                # 1-tick snapshot; restoring one without it would silently
                # treat an unchanged tick 0 as clean against φ
                no_prev = sorted(
                    n for n in state if specs[n].left_halo == 0
                    and n not in (sparse_state.get("prev") or {}))
                if no_prev:
                    raise ValueError(
                        f"checkpoint is missing the 1-tick 'prev' snapshot "
                        f"for halo-free inputs {no_prev}")

        self._t = int(t)
        self._tails = {k: self._lift(v) for k, v in state.items()}
        if self._sparse is not None:
            st = {"dirty": {}, "prev": {}, "seed": {}, "started": True}
            if sparse_state is not None:
                st["dirty"] = {k: self._lift(v)
                               for k, v in sparse_state["dirty"].items()
                               if k in names}
                # older checkpoints carried (dead) snapshots for
                # halo-carrying inputs too — drop them on the way in
                st["prev"] = {k: self._lift(v)
                              for k, v in sparse_state["prev"].items()
                              if k in names and specs[k].left_halo == 0}
                seed = sparse_state.get("seed") or {}
                if not isinstance(seed, dict):
                    # pre-policy-runner checkpoints (old KeyedEngine format)
                    # stored the solo hold seed as a bare (value, valid)
                    # tuple rather than a per-output dict
                    if not self.spec.solo:
                        raise ValueError(
                            "checkpoint hold seed is a bare tuple (single-"
                            "output format) but this runner serves a union "
                            "DAG with outputs "
                            f"{sorted(self.spec.out_precs)}")
                    seed = {"__out": seed}
                st["seed"] = {o: self._lift(v) for o, v in seed.items()
                              if o in self.spec.out_precs}
                st["started"] = bool(sparse_state.get("started", True))
            # φ-init any halo-free snapshot the checkpoint didn't carry
            # (strict mode rejected this above): the next chunk's tick 0
            # then diffs against φ, the stream-start rule
            for name, (tv, tm) in self._tails.items():
                if specs[name].left_halo == 0 and name not in st["prev"]:
                    st["prev"][name] = (
                        _tm(lambda x: torch.zeros(x.shape[:-1] + (1,),
                                                  dtype=x.dtype,
                                                  device=x.device), tv),
                        torch.zeros((tm.shape[0], 1), dtype=torch.bool,
                                    device=tm.device))
            self._sparse = st

    # -- late-data revision processing ---------------------------------------
    def enable_revision(self, horizon_chunks: int) -> None:
        """Keep a ring of the carried tails before each of the last
        ``horizon_chunks`` chunks, so sealed chunks inside the horizon can
        be revised through :meth:`revise` when late data patches their
        inputs (:meth:`repro_torch.core.plan.ChangePlan.
        revision_horizon_chunks` sizes the ring for a maximum lateness).

        The ring holds references to the carried tensors, which no step
        updates in place, so a runner with revision enabled makes no more
        transfers per chunk than one without (the reference copies its
        donated state to the host every chunk instead)."""
        if horizon_chunks < 1:
            raise ValueError("horizon_chunks must be >= 1")
        self._rev_ring = collections.deque(maxlen=int(horizon_chunks))
        self.revision_horizon = int(horizon_chunks)

    def _revision_step(self, dev: torch.device):
        """The late-data revision step: ``step(tails, chunks, w, cap) ->
        (outs, new_tails)``.

        Like the sparse step, the compute is the compacted body of one
        capacity (:meth:`_compute_local`), never a dense chunk replay; but
        the dirty units ``w`` arrive as an argument (derived on the host
        from :func:`repro_torch.core.sparse.retro_segment_mask` over the
        patched tick times, so the bucket ``cap`` is known without a
        device read) instead of being diffed on the device, and there is no
        hold fill: ChangePlan dilation proves every output outside the
        dirty segments unchanged, so only dirty segments' output ticks are
        read back (clean segments carry scatter residue)."""
        key = self._cache_key("revise", dev)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        names = self._names()
        K = self._K

        def step(tails, chunks, w, cap):
            bufs = {}
            for name in names:
                tv, tm = tails[name]
                cv, cm = chunks[name]
                bufs[name] = (_tm(_cat, tv, cv), _cat(tm, cm))
            full = self._compute_local(cap, dev)(w, bufs)
            outs = {o: (_tm(lambda x: _ticks(x.reshape(
                            (K, self.n_segs) + x.shape[1:]), self.n_segs),
                            fv),
                        fm.reshape(K, -1))
                    for o, (fv, fm) in full.items()}
            return outs, self._new_tails(bufs)

        cache[key] = step
        return step

    def revise(self, from_chunk: int, chunks, seg_dirty, *,
               commit: bool = True) -> List:
        """Re-run sealed chunks ``from_chunk .. from_chunk+len(chunks)-1``
        on patched inputs, computing only the flagged segments.

        ``chunks`` is one ``{input: SnapshotGrid}`` dict per revised chunk
        (the patched sealed grids, full chunk layout exactly as for
        :meth:`step`); ``seg_dirty`` one host bool mask per chunk, shaped
        ``(n_segs,)`` (single) or ``(n_keys, n_segs)`` (vmapped) —
        derived from :func:`repro_torch.core.sparse.retro_segment_mask`
        over the patched tick times.  Returns one output result per chunk
        in :meth:`step`'s layout; only ticks inside dirty segments are
        meaningful (callers emit corrections for those segments only —
        see :class:`repro_torch.ingest.IngestRunner`).

        With ``commit=True`` (required to keep live state consistent) the
        revision must extend through the newest stepped chunk; the
        walked-forward tails then replace the live carried tails, the
        change state goes conservative (all-dirty tails — a superset of
        true dirtiness, still bit-exact by the sparse exactness
        contract), and ring entries passed en route are refreshed with
        the patched tails so later revisions restore patched history.
        ``commit=False`` is a read-only what-if replay."""
        if self._rev_ring is None:
            raise ValueError(
                "revision disabled — call enable_revision() first")
        if len(chunks) != len(seg_dirty):
            raise ValueError("one seg_dirty mask per revised chunk required")
        span = self.n_segs * self.spec.span
        cur = self._t // span
        if commit and from_chunk + len(chunks) != cur:
            raise ValueError(
                f"commit=True revisions must extend through the newest "
                f"stepped chunk {cur - 1} (got chunks {from_chunk}.."
                f"{from_chunk + len(chunks) - 1})")
        entry = next((e for e in self._rev_ring
                      if e["chunk"] == from_chunk), None)
        if entry is None:
            have = sorted(e["chunk"] for e in self._rev_ring)
            raise ValueError(
                f"no state snapshot for chunk {from_chunk} in the revision "
                f"ring (have {have}) — the patch is beyond the horizon")
        K, U = self._K, self._U
        tails = None
        results = []
        n_units = 0
        last_in = last_sd = last_outs = None
        for i, (ch, sd) in enumerate(zip(chunks, seg_dirty)):
            chunk_in = self._ingest(ch)
            dev = self._chunk_device(chunk_in)
            if tails is None:
                tails = {n: _tm(lambda x: x.to(dev), entry["tails"][n])
                         for n in self._names()}
            else:
                # the ring entry for this chunk holds pre-patch tails —
                # refresh it with the walked (patched) ones so a later
                # revision restoring from here sees patched history
                for e in self._rev_ring:
                    if e["chunk"] == from_chunk + i:
                        e["tails"] = dict(tails)
            sd = np.asarray(sd, bool).reshape(K, self.n_segs)
            cnt = int(sd.sum())
            n_units += cnt
            # the mask is host data: its count picks the bucket without a
            # device read, and it reaches the card by an asynchronous copy
            w = torch.from_numpy(sd.reshape(U).copy())
            if dev.type == "cuda":
                w = w.pin_memory().to(dev, non_blocking=True)
            outs, tails = self._revision_step(dev)(
                tails, chunk_in, w, sparse_mod.bucket_capacity(cnt, U))
            last_in, last_sd, last_outs = chunk_in, w, outs
            res = {}
            for o, (v, m) in self._postprocess(outs).items():
                res[o] = SnapshotGrid(value=v, valid=m,
                                      t0=(from_chunk + i) * span,
                                      prec=self.spec.out_precs[o])
            results.append(res["__out"] if self.spec.solo else res)

        if commit and chunks:
            self._tails = tails
            if self._sparse is not None:
                st = self._sparse
                ld = last_sd.reshape(K, self.n_segs)[:, -1]
                for name in self._names():
                    hl = self.spec.input_specs[name].left_halo
                    if hl:
                        # conservative: the patched tail is marked fully
                        # dirty — dirtiness only ever widens, and extra
                        # computed segments are bit-identical by the
                        # sparse exactness contract
                        st["dirty"][name] = torch.ones(
                            (K, hl), dtype=torch.bool, device=ld.device)
                    else:
                        cv, cm = last_in[name]
                        st["prev"][name] = (
                            _tm(lambda x: x[..., -1:].clone(), cv),
                            cm[:, -1:].clone())
                for o, (sv, sm) in list(st["seed"].items()):
                    ov, om = last_outs[o]
                    st["seed"][o] = (
                        _tm(lambda x, s: torch.where(_bc(ld, x[..., -1]),
                                                     x[..., -1], s),
                            ov, sv),
                        torch.where(ld, om[:, -1], sm))
        if self.metrics.on:
            self._m_rev_runs.add(1)
            self._m_rev_chunks.add(len(chunks))
            self._m_rev_units.add(n_units)
        return results

    # -- not ported yet ----------------------------------------------------
    def staged_steps(self, *args, **kwargs):
        raise NotImplementedError(
            "AOT serving (staged_steps, chunk_fn, aot_keys, "
            "install_executable) is not ported yet: ROADMAP A13")

    chunk_fn = aot_keys = install_executable = seed_shape_spec = \
        staged_steps

    def audit_example_chunks(self, *args, **kwargs):
        raise NotImplementedError(
            "the static-audit surface is not ported yet: ROADMAP A15")
