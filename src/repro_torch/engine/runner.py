"""One chunked runner for every execution policy (body × keys × placement
× dag); port of ``repro.engine.runner``.

:class:`Runner` evaluates the planned partition body over a chunk's
segments with the carried halo tails in front of it, moves the new tails
to the front, advances a stream clock and checkpoints it all, under an
:class:`repro_torch.engine.policy.ExecPolicy`.

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
* ``placement=mesh(axis)`` shards the *work-unit* axis over one axis of a
  device mesh, one process per rank, every rank stepping the same global
  chunks: whole keys when keyed (rank ``r`` owns keys ``[r·K/n,
  (r+1)·K/n)`` and their carried state; keys never communicate), segments
  when single-keyed (the chunk buffer and the carried state are
  replicated, and rank ``r`` computes segments ``[r·S/n, (r+1)·S/n)``).
  Sparse compaction is **per shard**: each rank compacts its own dirty
  units into a capacity bucket of the per-shard ladder (``U // n``), so
  the gather never crosses ranks.  :meth:`Runner.step` returns the whole
  (all-gathered) grid on every rank: one all-gather per output dtype at
  the end of the step (keyed: along the key axis; single-keyed: along
  time; the single-keyed sparse body gathers the compacted outputs
  before its hold fill, which reads the neighbours' segments).  On the
  card the gathers are NCCL collectives captured in the step's graphs
  (a keyed sparse step replays one more graph, the gather, after its
  switched graph), so a steady chunk still reads nothing on the host
  and dispatches no collective of its own.
* Units ride the evaluator's leading axis: the unit windows are gathered
  into ``(U, L)`` grids and the compiled query runs once per chunk over
  all of them (the reference ``vmap``s the body over units instead).
* ``dag='union'`` runs the union DAG of N queries (one
  :class:`repro_torch.core.plan.UnionPlan`, see
  :func:`repro_torch.multiquery.union_runner`) and returns one grid per
  query; the merged :class:`~repro_torch.core.plan.ChangePlan` of the union
  is the per-input union of the per-query dilations, so the sparse body
  composes with multi-query sharing.
* Late data: with :meth:`Runner.enable_revision` the runner keeps copies
  of the carried tails of its last chunks, and :meth:`Runner.revise`
  re-runs sealed chunks on patched inputs, computing only the segments the
  late change can reach (the compacted body, never a dense replay).

State lives in place.  A runner steps in buffers allocated once per
geometry and chunk layout (:class:`_Work`): per input one buffer holds the
carried tail followed by the chunk, so a chunk is copied in and nothing is
concatenated; the sparse change state, the hold seeds and the device
metric accumulators sit beside it.  A step writes its new state into these
buffers at its end (after everything that can raise), which is what the
reference's donated state does.  :meth:`state` and :meth:`restore` copy
out of and into them.

On a CUDA device every step is a captured CUDA graph
(:mod:`repro_torch.engine.capture`): the first use of each (variant,
bucket) key warms the step up on a side stream, captures it over the
static buffers and keeps the graph; every later chunk copies its grids
into the buffers and replays.  The sparse step picks its compaction
bucket on the device (the count never leaves the card), so a steady chunk
issues no synchronizing call and no per-op dispatch.  On the CPU the same
step functions run eagerly, and the sparse body reads its count there.

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

The static audit (:mod:`repro_torch.analysis`) reads the runner through
:meth:`Runner.audit_example_chunks`, :meth:`Runner.staged_steps`,
:meth:`Runner.chunk_fn`, :meth:`Runner.staging_key_dofs`, the workspace's
state buffers by path (:meth:`_Work.state_buffers`) and the frames a
step's parts run in (:func:`repro_torch.engine.capture.frame`).
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                 tree_unflatten)

from ..core import ir
from ..core import sparse as sparse_mod
from ..core.plan import ChangePlan, InputSpec, QueryPlan, seg_range_affine
from ..core.stream import SnapshotGrid
from ..device import resolve
from ..kernels import sparse_compact
from ..launch.mesh import axis_comm, merge_ranks, mesh_device
from ..obs import Metrics, log_buckets
from . import capture
from .policy import ExecPolicy

__all__ = ["BodySpec", "Runner", "ShapeDtype", "body_spec_of"]

_tm = tree_map


@dataclasses.dataclass
class BodySpec:
    """Everything the runner needs to know about a per-segment body.

    A body evaluates one planned partition: given ``{input_name: (value,
    valid)}`` grids covering one segment plus halo (``input_specs``), or
    only the ticks it evaluates (:meth:`unit_windows`), with any number of
    units on a leading axis, it returns ``{out_name: (value,
    valid)}`` output grids of ``span // out_precs[name]`` ticks per unit.
    Solo queries are the single-output case (``out_name == "__out"``);
    union DAGs return one entry per query.

    ``step_cache`` holds the built chunk steps, keyed by execution
    geometry and device — share it across Runner instances over the same
    compiled query so fresh runners reuse them.  ``plan`` and ``sum_algo``
    (solo bodies) are what a persisted plan artifact records
    (:func:`repro_torch.serve.plan_artifact_of`); the runner reads the
    evaluated windows off ``plan`` (:meth:`unit_windows`).
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
    plan: Optional[QueryPlan] = None   # None: an opaque body
    sum_algo: str = "block"
    # IR roots backing outs_fn, for static verification (repro_torch.
    # analysis): solo bodies carry (root,); union bodies one root per
    # query.  Empty means the body is opaque (a hand-built outs_fn) and the
    # temporal-plan verifier can only check internal plan consistency.
    roots: tuple = ()

    @property
    def span(self) -> int:
        return self.out_len * self.out_prec

    def unit_windows(self) -> Dict[str, tuple]:
        """Per input, ``(offset, length, core)``: the ticks the body
        evaluates inside a unit's contract window (``input_specs``), the
        plan's evaluated window (:meth:`QueryPlan.evaluated`, a suffix) or
        the whole window for an opaque body, and the ticks a unit adds."""
        out = {}
        for name, s in self.input_specs.items():
            if self.plan is None:
                out[name] = (0, s.length, s.core)
            else:
                g = self.plan.evaluated(name)
                out[name] = ((g.t0 - s.t0) // s.prec, g.length, s.core)
        return out


def body_spec_of(exe) -> BodySpec:
    """The :class:`BodySpec` of a :class:`repro_torch.core.compile.
    CompiledQuery` (the ``dag='solo'`` case).  The step cache lives on the
    CompiledQuery, so every Runner over the same executable shares built
    steps."""

    def outs_fn(inputs: Dict[str, tuple]) -> Dict[str, tuple]:
        return {"__out": exe.trace_fn(inputs)}

    return BodySpec(
        input_specs=exe.input_specs, out_len=exe.out_len,
        out_prec=exe.out_prec, outs_fn=outs_fn,
        out_precs={"__out": exe.out_prec},
        change_plan=exe.change_plan, root=exe.root, solo=True,
        step_cache=exe.__dict__.setdefault("_runner_step_cache", {}),
        plan=exe.plan, sum_algo=exe.sum_algo,
        roots=(exe.root,) if exe.root is not None else ())


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype name of one hold-seed leaf: what a persisted seed
    spec records (plain data, so a plan store can hold it)."""

    shape: tuple
    dtype: str

    @classmethod
    def of(cls, x: torch.Tensor) -> "ShapeDtype":
        return cls(tuple(x.shape), str(x.dtype).removeprefix("torch."))

    def zeros(self, device) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=getattr(torch, self.dtype),
                           device=device)


def _bc(mask, x):
    """Broadcast a leading-axes mask over the trailing dims of ``x``."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


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


def _copy_tree(dst, src) -> None:
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def _zero_tree(dst) -> None:
    for d in tree_leaves(dst):
        d.zero_()


def _pack(tree):
    """Every tensor of ``tree`` copied into one flat tensor per dtype, and
    the layout to take them apart again (:func:`_unpack`): a captured step
    returns its outputs this way, so one copy per dtype hands a replay's
    results to the caller.  The copy also keeps the outputs apart from the
    buffers the step moves afterwards."""
    leaves, spec = tree_flatten(tree)
    groups: Dict[torch.dtype, list] = {}
    layout = []
    for x in leaves:
        g = groups.setdefault(x.dtype, [])
        layout.append((x.dtype, sum(t.numel() for t in g), tuple(x.shape)))
        g.append(x.reshape(-1))
    flats = {dt: (torch.cat(g) if len(g) > 1 else g[0].clone())
             for dt, g in groups.items()}
    return flats, (spec, layout)


def _unpack(flats, packing):
    spec, layout = packing
    return tree_unflatten(
        [flats[dt][o:o + math.prod(shape)].view(shape)
         for dt, o, shape in layout], spec)


def _unpack_merged(gflats, packing, dim: int):
    """:func:`_unpack` of every rank's packed tensors, ``gflats[dtype]`` of
    shape ``(n, numel)`` (an all-gather of the flats), each leaf's parts
    concatenated in rank order along ``dim``."""
    spec, layout = packing
    return tree_unflatten(
        [merge_ranks(gflats[dt][:, o:o + math.prod(shape)].reshape(
            (gflats[dt].shape[0],) + shape), dim)
         for dt, o, shape in layout], spec)


def _gather_packed(comm, dim: int, packed):
    """Every rank's packed results (:func:`_pack`) all-gathered — one
    collective per dtype — as the global results packed: each leaf's parts
    joined in rank order along ``dim`` (0: keys; -1: time), in the layout
    the caller unpacks as a local step's.  Where the rank-major gather is
    that layout already (one rank; or one leaf per dtype, gathered along
    its outermost non-unit axis) it is returned as it is, otherwise the
    leaves are joined and packed again (one more copy)."""
    flats, (spec, layout) = packed
    n = comm.n
    gflats = {dt: comm.gather_flat(f) for dt, f in flats.items()}
    per_dtype = collections.Counter(dt for dt, _o, _s in layout)
    if n > 1 and not all(
            per_dtype[dt] == 1 and math.prod(shape[:dim % len(shape)]) == 1
            for dt, _o, shape in layout):
        return _pack(_unpack_merged(gflats, (spec, layout), dim))

    def joined(shape):
        d = dim % len(shape)
        return shape[:d] + (shape[d] * n,) + shape[d + 1:]

    return ({dt: g.view(-1) for dt, g in gflats.items()},
            (spec, [(dt, o * n, joined(shape)) for dt, o, shape in layout]))


def _units(windows, n_segs: int, bufs, ids=None, segs=None):
    """Unit windows of every input, units on the leading axis: all ``U``
    units (``ids=None``, unit ``u = key·n_segs + segment``; only the
    segments of the range ``segs`` when given) or the ones named by
    ``ids``.  ``windows[name]`` is :meth:`BodySpec.unit_windows`'s
    ``(offset, length, core)``: a unit's window is the ``length`` ticks
    from ``offset`` of its contract window, the ones the body evaluates."""
    out = {}
    for name, (fv, fm) in bufs.items():
        off, L, core = windows[name]
        if ids is None:
            def take(x, off=off, L=L, core=core):
                w = _windows(x[..., off:], L, core)
                if segs is not None:
                    w = w[:, segs[0]:segs[1]]
                return w.reshape((-1,) + w.shape[2:])
        else:
            k_ids, s_ids = ids // n_segs, ids % n_segs

            def take(x, off=off, L=L, core=core, k_ids=k_ids, s_ids=s_ids):
                return _windows(x[..., off:], L, core)[k_ids, s_ids]
        out[name] = (_tm(take, fv), take(fm))
    return out


def _per_key(full, K: int, n_segs: int):
    """``(U, ..., S)`` unit outputs → ``(K, ..., n_segs·S)`` grids."""
    return {o: (_tm(lambda x: _ticks(x.reshape((K, n_segs) + x.shape[1:]),
                                     n_segs), fv),
                fm.reshape(K, -1))
            for o, (fv, fm) in full.items()}


def _hold(full_outs, seg_dirty, seeds, ar, K: int, n_segs: int):
    """Hold fill: clean units take the last tick of the nearest
    preceding dirty segment of the same key, or the key's carried hold
    seed; dirty units keep their computed results."""
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


class _Work:
    """The buffers a runner steps in, allocated once per geometry and chunk
    layout.

    Per input one buffer ``(K, ..., left_halo + n)``: its first
    ``left_halo`` ticks are the carried tail, the rest the chunk
    (:meth:`load` copies a chunk in; :meth:`shift` moves the new tail to
    the front in place).  A sparse runner's buffers also hold the change
    state (dirty tails, 1-tick snapshots of halo-free inputs, hold seeds),
    the step's scratch (next dirty tails, the segment mask, the dirty-unit
    count, the compacted bodies' output) and the device metric
    accumulators; a revision's buffers hold the host-made unit mask
    instead.  On the card a runner's captured graphs read and write these
    tensors and nothing else that outlives them, and live here
    (``graphs``), in one memory pool.

    Under a mesh the buffers hold this rank's keys (keyed) or the whole
    replicated chunk (single-keyed), and the compacted outputs ``full``
    this rank's computed units only; ``full`` is a set of views into one
    flat tensor per dtype, so a single-keyed sparse step all-gathers it
    into ``gfull`` with one collective per dtype.
    """

    def __init__(self, runner: "Runner", chunk_in: Dict[str, tuple],
                 dev: torch.device, *, seeds=None, revision: bool = False):
        K, n_segs, Uc = runner._K, runner.n_segs, runner._Uc
        self.u0, self.uc = runner._u0, Uc
        specs = runner.spec.input_specs
        self.dev, self.layout = dev, _layout(chunk_in)
        self.names = runner._names()
        self.hl, self.n, self.bufs, self._chunk = {}, {}, {}, {}

        def z(shape, dtype=torch.bool):
            return torch.zeros(shape, dtype=dtype, device=dev)

        for name in self.names:
            s = specs[name]
            hl, n = s.left_halo, s.core * n_segs
            cv, _cm = chunk_in[name]
            bv = _tm(lambda x: z(x.shape[:-1] + (hl + n,), x.dtype), cv)
            bm = z((K, hl + n))
            self.hl[name], self.n[name], self.bufs[name] = hl, n, (bv, bm)
            self._chunk[name] = [x[..., hl:] for x in tree_leaves((bv, bm))]
        self.sparse = seeds is not None
        self._w = z((Uc,)) if revision else None
        if self.sparse:
            self.dirty = {nm: z((K, self.hl[nm])) for nm in self.names}
            self.next_dirty = {nm: z((K, self.hl[nm])) for nm in self.names
                               if self.hl[nm]}
            self.prev = {nm: (_tm(lambda x: z(x.shape[:-1] + (1,), x.dtype),
                                  chunk_in[nm][0]), z((K, 1)))
                         for nm in self.names if self.hl[nm] == 0}
            self.seed = {o: _tm(lambda a: z(a.shape, a.dtype), sd)
                         for o, sd in seeds.items()}
            span = runner.spec.span
            self.full_flats, self.full_packing = _pack({
                o: (_tm(lambda a, S=span // runner.spec.out_precs[o]:
                        z((Uc,) + tuple(a.shape[1:]) + (S,), a.dtype), sv),
                    z((Uc, span // runner.spec.out_precs[o])))
                for o, (sv, _sm) in seeds.items()})
            self.full = _unpack(self.full_flats, self.full_packing)
            self.gfull_flats = (
                {dt: z((runner._n,) + tuple(f.shape), dt)
                 for dt, f in self.full_flats.items()}
                if runner._seg_mesh else None)
            self.seg = z((K, n_segs))
            self.cnt = z((), torch.int32)
            # the dirty-unit total: the shard's own count but for
            # single-keyed mesh runners, whose mask covers every segment
            self.tot = z((), torch.int32) if runner._seg_mesh else self.cnt
            self.caps = torch.as_tensor(sparse_mod.capacity_ladder(Uc),
                                        dtype=torch.int64, device=dev)
            self.mstate = (z((), torch.int32),
                           z((len(runner._obs_caps),), torch.int32),
                           z((len(runner._obs_frac_edges) + 1,),
                             torch.int32))
        self.graphs: dict = {}
        self.pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                     else None)

    @property
    def w(self) -> torch.Tensor:
        """The unit mask the compacted bodies read: this rank's ``(Uc,)``
        slice of the segment mask (all of it unless single-keyed on a
        mesh), or a revision's host-made mask."""
        if not self.sparse:
            return self._w
        return self.seg.reshape(-1)[self.u0:self.u0 + self.uc]

    def state_buffers(self) -> Dict[str, torch.Tensor]:
        """The carried state, by path: each halo-carrying input's buffer
        (``tails[name][i]``: its tail is the state), and on a sparse
        runner the dirty tails, the 1-tick snapshots, the hold seeds and
        the metric accumulators; a revision workspace's buffers under
        ``revision.``.  Empty tensors carry nothing and are left out."""
        out: Dict[str, torch.Tensor] = {}
        pre = "revision." if self._w is not None else ""

        def put(path, tree):
            for i, x in enumerate(tree_leaves(tree)):
                if x.numel():
                    out[f"{pre}{path}[{i}]"] = x

        for nm in self.names:
            if self.hl[nm]:
                put(f"tails[{nm!r}]", self.bufs[nm])
        if self.sparse:
            for part in ("dirty", "prev", "seed"):
                for k, tree in getattr(self, part).items():
                    put(f"{part}[{k!r}]", tree)
            put("metrics", self.mstate)
        return out

    def tails(self) -> Dict[str, tuple]:
        """Views of the carried tails."""
        return {nm: _tm(lambda x, hl=self.hl[nm]: x[..., :hl],
                        self.bufs[nm]) for nm in self.names}

    def load(self, chunk_in: Dict[str, tuple]) -> None:
        """Copy a chunk's grids behind the carried tails."""
        for name in self.names:
            for dst, src in zip(self._chunk[name],
                                tree_leaves(chunk_in[name])):
                dst.copy_(src)

    def chunk(self, name: str) -> tuple:
        bv, bm = self.bufs[name]
        hl = self.hl[name]
        return _tm(lambda x: x[..., hl:], bv), bm[:, hl:]

    def shift(self) -> None:
        """The new tails (the buffers' last ``left_halo`` ticks) to the
        front, in place."""
        for name in self.names:
            hl, n = self.hl[name], self.n[name]
            if not hl:
                continue
            for x in tree_leaves(self.bufs[name]):
                src = x[..., n:]
                x[..., :hl].copy_(src if n >= hl else src.clone())

    def clone(self) -> "_Work":
        """A scratch copy of every tensor, for a warm-up run that must not
        touch the live state."""
        c = copy.copy(self)
        cl = lambda t: _tm(lambda x: x.clone(), t)  # noqa: E731
        c.bufs = cl(self.bufs)
        c._chunk = {nm: [x[..., self.hl[nm]:] for x in tree_leaves(b)]
                    for nm, b in c.bufs.items()}
        c._w = None if self._w is None else self._w.clone()
        if self.sparse:
            for part in ("dirty", "next_dirty", "prev", "seed", "seg",
                         "cnt", "mstate", "full_flats"):
                setattr(c, part, cl(getattr(self, part)))
            if self.gfull_flats is not None:
                c.gfull_flats = cl(self.gfull_flats)
            c.tot = c.cnt if self.tot is self.cnt else self.tot.clone()
            c.full = _unpack(c.full_flats, c.full_packing)
        c.graphs = {}
        return c


def _layout(chunk_in: Dict[str, tuple]) -> tuple:
    """What a workspace is allocated for: every input's value structure,
    leaf shapes (time excluded) and dtypes."""
    out = []
    for name in sorted(chunk_in):
        leaves, spec = tree_flatten(chunk_in[name][0])
        out.append((name, str(spec), tuple((tuple(x.shape[:-1]), x.dtype)
                                           for x in leaves)))
    return tuple(out)


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
        The execution policy.  ``keys='vmapped'`` requires ``n_keys``;
        ``placement=mesh`` shards keys (vmapped) or segments (single) and
        requires the respective count to divide the mesh axis size.
    segs_per_chunk:
        Segments consumed per :meth:`step`; each chunk supplies
        ``segs_per_chunk · spec.core`` fresh ticks per input.
    metrics:
        A :class:`repro_torch.obs.Metrics` registry to accumulate runtime
        telemetry into (``runner.*`` metric names).  Default: a fresh
        private registry on ``self.metrics``.

    The runner runs on the device of the chunks it is given; restored
    state moves there at the next step.  Under a mesh every rank builds
    the runner with the same arguments and steps it with the same global
    chunks (each rank keeps what it owns), on the mesh's device.
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
        self._unit_windows = spec.unit_windows()
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
        n = policy.n_shards
        if policy.mesh is not None:
            if policy.keyed and self.n_keys % n:
                raise ValueError(
                    f"n_keys={self.n_keys} not divisible by mesh axis "
                    f"'{policy.axis}' of size {n}")
            if not policy.keyed and self.n_segs % n:
                raise ValueError(
                    f"segs_per_chunk={self.n_segs} not divisible by mesh "
                    f"axis '{policy.axis}' of size {n}")
        # -- geometry: this rank's keys (_K from _k0) and the units its
        # buffers and segment mask cover (_U = _K·n_segs); the units it
        # computes (_Uc from _u0: a slice of the segments when single-keyed
        # on a mesh, all of _U otherwise)
        self._n, self._rank = n, policy.rank
        self._comm = (axis_comm(policy.mesh, policy.axis)
                      if policy.mesh is not None else None)
        self._seg_mesh = policy.mesh is not None and not policy.keyed
        self._K = self.n_keys // n if policy.keyed else 1
        self._U = self._K * self.n_segs
        self._Uc = self._U // n if self._seg_mesh else self._U
        self._u0 = self._rank * self._Uc if self._seg_mesh else 0
        self._k0 = self._rank * self._K if policy.keyed else 0

        # -- the state pytree: views into the live workspace once bound, or
        # tensors a restore brought (copied in at the next step) ----------
        self._tails: Dict[str, tuple] = {}
        self._sparse: Optional[dict] = (
            {"dirty": {}, "prev": {}, "seed": {}, "started": False}
            if policy.sparse else None)
        self._seeded: set = set()     # outputs whose hold seed is carried
        self._t = 0
        self._work: Optional[_Work] = None
        self._rwork: Optional[_Work] = None
        self._bound = False
        self._zero_seed_cache = None
        # -- sparse-body diagnostics (device-resident: reading them via
        # dirty_stats() syncs, accumulating them does not) ------------------
        self.last_seg_dirty = None
        self._total_units = 0
        self._chunks_run = 0
        # -- late-data revision ring (off unless enable_revision) -----------
        self._rev_ring: Optional[collections.deque] = None
        self.revision_horizon = 0
        self.revise_bound: Optional[int] = None
        self._obs_init(metrics)

    # -- telemetry -----------------------------------------------------------
    def _obs_init(self, metrics: Optional[Metrics]) -> None:
        """Create/bind the runner's metric handles.  Device-resident
        metrics hold references to the live workspace's accumulators
        (``_Work.mstate``), which every sparse step updates in place on
        the device; host metrics are plain Python arithmetic."""
        self.metrics = m = metrics if metrics is not None else Metrics()
        self._m_chunks = m.counter(
            "runner.chunks", "chunks stepped", "chunks")
        self._m_units = m.counter(
            "runner.units", "work units (keys x segments) presented",
            "units")
        self._m_keys = m.gauge("runner.keys", "keyed sub-streams", "keys")
        self._m_trim = {
            name: m.gauge(f"runner.eval_trim_pct.{name}",
                          "share of the contract's unit window the body "
                          "does not evaluate", "%")
            for name in self._unit_windows}
        self._m_halo = {
            name: m.gauge(f"runner.halo_eval_pct.{name}",
                          "share of the ticks the body evaluates of a unit "
                          "window that lie before the unit's core: the "
                          "lookback every unit evaluates again", "%")
            for name in self._unit_windows}
        self._obs_static()
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
        # into the host base before this runner's accumulators take over
        self._m_dirty = m.counter(
            "runner.dirty_units", "work units that actually computed",
            "units")
        self._m_dirty.fold_device()
        ladder = (sparse_mod.capacity_ladder(self._Uc)
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

    def _obs_static(self) -> None:
        """Set the gauges fixed by the plan and the geometry."""
        self._m_keys.set(self.n_keys)
        for name, (off, L, core) in self._unit_windows.items():
            self._m_trim[name].set(100.0 * off / (off + L))
            self._m_halo[name].set(100.0 * max(L - core, 0) / L)

    def _obs_bind(self) -> None:
        """Point the device-resident metrics at the live accumulators (a
        reference assignment: no launch, no read)."""
        total, picks, frac = self._work.mstate
        self._m_dirty.set_device(total)
        self._m_picks.set_device(picks)
        self._m_frac.set_device(frac)

    def _obs_fold(self) -> None:
        """Fold the live accumulators into the registry's host bases and
        clear them (syncs — off the hot path)."""
        if self._work is None or not self._work.sparse:
            return
        self._obs_bind()
        self._m_dirty.fold_device()
        self._m_picks.fold_device()
        self._m_frac.fold_device()
        _zero_tree(self._work.mstate)

    def _obs_warmup_reset(self) -> None:
        """Registry warmup-reset hook (:meth:`repro_torch.obs.Metrics.
        reset_after_warmup`): re-base this runner's device accumulators
        (in place: the captured steps hold their addresses) and compaction
        window; the stream state itself is untouched."""
        if self._work is not None and self._work.sparse:
            _zero_tree(self._work.mstate)
            if self.metrics.on:
                self._obs_bind()
        self._total_units = 0
        self._chunks_run = 0
        self._obs_static()

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
        ``scatter_add_`` — no host read, no bincount, no mask indexing.
        Under a mesh the picks are this rank's (per-shard buckets); the
        total and the fraction are over the units its mask covers (every
        segment when single-keyed, its own keys' when keyed), as are the
        ``runner.units`` counter and :meth:`dirty_stats`."""
        key = self._cache_key("obs_accum", dev)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        caps = torch.as_tensor(self._obs_caps, device=dev)
        edges = torch.as_tensor(self._obs_frac_edges, dtype=torch.float32,
                                device=dev)
        one = torch.ones(1, dtype=torch.int32, device=dev)
        U, top = self._U, len(self._obs_caps) - 1

        def accum(mstate, cnt, tot):
            total, picks, frac = mstate
            b = torch.clamp(torch.searchsorted(caps, cnt.reshape(1)), 0, top)
            fi = torch.searchsorted(edges, tot.reshape(1).float() / U)
            total.add_(tot)
            picks.scatter_add_(0, b, one)
            frac.scatter_add_(0, fi, one)

        cache[key] = accum
        return accum

    # -- geometry ------------------------------------------------------------
    def _names(self):
        return sorted(self.spec.input_specs)

    # every configuration degree of freedom the built steps close over;
    # _cache_key is built from exactly these (in this order), so the step
    # cache is never keyed on less than the steps depend on.  Under a mesh
    # "mesh" is its shape, this rank's index along the axis and the axis
    # group's serial (the steps gather through that group).
    _KEY_DOFS = ("K", "n_segs", "device", "mesh", "axis")

    def staging_key_dofs(self, dev=None) -> Dict:
        """The step-cache key's degrees of freedom, by name."""
        mesh = self.policy.mesh
        return {"K": self._K, "n_segs": self.n_segs, "device": str(dev),
                "mesh": (None if mesh is None
                         else (tuple(mesh.shape), self._rank,
                               self._comm.serial)),
                "axis": self.policy.axis if mesh is not None else None}

    def _cache_key(self, kind, dev, *extra):
        """Step-cache key: the geometry the built steps close over (the
        local key count, the segments, the device their index tensors
        live on, the mesh's shape and axis), then ``extra`` (the capacity
        of a compute step last)."""
        dofs = self.staging_key_dofs(dev)
        return (kind,) + tuple(dofs[k] for k in self._KEY_DOFS) + extra

    def _compile_label(self, key) -> str:
        """The recompile detector's unit of accounting (device-free, as
        the reference's labels)."""
        kind, K, n_segs, axis = key[0], key[1], key[2], key[5]
        parts = [f"K={K}", f"segs={n_segs}"]
        if axis is not None:
            parts.append(f"mesh={axis}")
        parts += [str(x) for x in key[6:]]
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
            elif self._n > 1:          # this rank's keys (views)
                k0, k1 = self._k0, self._k0 + self._K
                v, m = _tm(lambda x: x[k0:k1], v), m[k0:k1]
            chunk_in[name] = (v, m)
        return chunk_in

    def _chunk_device(self, chunk_in) -> torch.device:
        for _, m in chunk_in.values():
            return m.device
        return self._work.dev if self._work is not None else \
            torch.device("cpu")

    # -- the workspace and the state bound to it -----------------------------
    def _live(self, chunk_in, dev: torch.device) -> _Work:
        """The live workspace for this chunk's layout, with the carried
        state in it.  Allocating a workspace, or copying restored state
        into one, happens at the first chunk and after a restore, never
        in a steady chunk."""
        work = self._work
        if work is None or work.layout != _layout(chunk_in) \
                or work.dev != dev:
            seeds = (self._zero_seeds(chunk_in, dev) if self.policy.sparse
                     else None)
            new = _Work(self, chunk_in, dev, seeds=seeds)
            if work is not None and work.sparse:
                _copy_tree(new.mstate, work.mstate)
            self._work, self._bound = new, False
            work = new
        if not self._bound:
            self._bind(work)
        return work

    def _bind(self, work: _Work) -> None:
        """Copy the logical state (restored tensors, or another
        workspace's views) into ``work`` — φ where it has none — and point
        the state dicts at ``work``'s views."""
        tails = work.tails()
        for name, dst in tails.items():
            src = self._tails.get(name)
            if src is None:
                _zero_tree(dst)
            else:
                _copy_tree(dst, self._mine(src))
        self._tails = tails
        if work.sparse:
            st = self._sparse
            for part, have in (("dirty", work.dirty), ("prev", work.prev),
                               ("seed", work.seed)):
                for key, dst in have.items():
                    src = st[part].get(key)
                    if src is None:
                        _zero_tree(dst)
                    else:
                        _copy_tree(dst, self._mine(src))
            self._seeded = {o for o in st["seed"] if o in work.seed}
            st["dirty"], st["prev"], st["seed"] = (work.dirty, work.prev,
                                                   work.seed)
            if self.metrics.on:
                self._obs_bind()
        self._bound = True

    def _zero_seeds(self, chunk_in, dev):
        """φ hold seeds shaped like one output tick per key (unread: any
        output missing a carried seed forces its first segment dirty).
        The shapes come from evaluating the body once on a zero input of
        one unit, on the runner's device, unless a persisted seed spec
        primed them (:meth:`prime_seed_shapes`)."""
        if self._zero_seed_cache is not None:
            return self._zero_seed_cache
        zeros = {}
        for name in self._names():
            L = self.spec.input_specs[name].length
            cv, cm = chunk_in[name]
            zeros[name] = (
                _tm(lambda x: torch.zeros((1,) + x.shape[1:-1] + (L,),
                                          dtype=x.dtype, device=dev), cv),
                torch.zeros((1, L), dtype=torch.bool, device=dev))
        outs = self.spec.outs_fn(zeros)
        K = self._K
        self._zero_seed_cache = {
            o: (_tm(lambda a: torch.zeros((K,) + a.shape[1:-1],
                                          dtype=a.dtype, device=dev), ov),
                torch.zeros((K,), dtype=torch.bool, device=dev))
            for o, (ov, om) in outs.items()}
        return self._zero_seed_cache

    # -- running a step: eager on the CPU, captured on the card ------------
    def _graph(self, work: _Work, key, cache_key, step):
        """The graph of ``step`` over ``work`` under ``key``: warmed up and
        captured at its first use (recorded under the label of the step's
        ``cache_key``)."""
        g = work.graphs.get(key)
        if g is None:
            tr = self.metrics.tracer
            tr.record_capture(self._compile_label(cache_key))
            with tr.span("runner.capture"):
                with tr.span("warm_up"), capture.warm_up(work.dev):
                    step(work.clone())
                with tr.span("record"):
                    g = work.graphs[key] = capture.record(
                        lambda: step(work), work.pool)
        return g

    def _launch(self, work: _Work, key, cache_key, step):
        """``step(work)`` → packed results: eagerly on the CPU, in a
        ``step`` frame; on the card a replay of the graph of ``key``, its
        static results (:meth:`_copy_out` copies them)."""
        if work.dev.type != "cuda":
            with capture.frame("step"):
                return step(work)
        return self._graph(work, key, cache_key, step).replay()

    @staticmethod
    def _copy_out(work: _Work, packed):
        """A step's packed results unpacked; on the card from copies (the
        graph's next replay rewrites its static results)."""
        flats, packing = packed
        if work.dev.type == "cuda":
            flats = {dt: f.clone() for dt, f in flats.items()}
        return _unpack(flats, packing)

    def _gather(self):
        """``gather(packed)``: :func:`_gather_packed` along this runner's
        work axis, or ``None`` when it is not on a mesh (what a step ends
        with: the step cache keys carry the mesh, so a built step may
        close over it)."""
        if self._comm is None:
            return None
        return functools.partial(_gather_packed, self._comm,
                                 0 if self.policy.keyed else -1)

    # -- dense step ----------------------------------------------------------
    def _dense_step(self, dev: torch.device):
        key = self._cache_key("dense", dev)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        outs_fn, wins = self.spec.outs_fn, self._unit_windows
        K, n_segs = self._K, self.n_segs
        # this rank's segments (all of them unless single-keyed on a mesh)
        segs = ((self._u0, self._u0 + self._Uc) if self._seg_mesh
                else None)
        n_own = self._Uc // K
        gather = self._gather()

        def step(work):
            packed = _pack(_per_key(outs_fn(_units(
                wins, n_segs, work.bufs, segs=segs)), K, n_own))
            work.shift()
            return gather(packed) if gather else packed

        cache[key] = step
        return step

    # -- sparse body -----------------------------------------------------------
    #
    # One step per chunk, in three parts: the prefix (fused change detection
    # and carried flags → the segment mask and the dirty-unit count), the
    # compacted compute of one capacity, and the suffix (hold fill, outputs,
    # the state written in place).  On the CPU the count picks the capacity
    # on the host; on the card the parts are captured and composed into one
    # graph that picks it on the device (capture.Switched).

    def _compute_local(self, cap: int, dev: torch.device):
        """Compute body for one compaction capacity: resolve the dirty
        units of ``w`` (this rank's units) into ``cap`` fixed-size ids
        without a host read, gather their halo windows, evaluate them
        only, scatter the results back over the rank's unit axis.  Built
        on first use of each capacity (of the per-shard ladder under a
        mesh)."""
        key = self._cache_key("compute", dev, cap)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        outs_fn, wins, n_segs = (self.spec.outs_fn, self._unit_windows,
                                 self.n_segs)
        u0 = self._u0
        segs = (u0, u0 + self._Uc) if self._seg_mesh else None

        if cap == self._Uc:
            # full-capacity bucket (count > Uc/2): compaction saves
            # nothing, so compute every unit in place.  Bit-identical:
            # computing a clean unit yields exactly its hold value (the
            # sparse exactness contract), and the hold fill downstream
            # still overwrites clean units from the dirty chain.
            def local(w, bufs):
                return outs_fn(_units(wins, n_segs, bufs, segs=segs))
        else:
            def local(w, bufs):
                # ids of this rank's units, offset to index the buffer
                ids, pos = sparse_mod.compact_ids(w, cap, base=u0)
                outs = outs_fn(_units(wins, n_segs, bufs, ids))  # (cap, ...)
                return {o: (_tm(lambda x: x.index_select(0, pos), ov),
                            om.index_select(0, pos))
                        for o, (ov, om) in outs.items()}    # (U, ..., S)

        cache[key] = local
        return local

    def _sparse_step(self, force_first: bool, dev: torch.device):
        """The prefix of a sparse chunk, ``prefix(work)``: per-segment
        change detection (the ``seg_dirty`` kernel over every input's
        buffer, plus the carried position-0 flags) into ``work.seg``, the
        dirty-unit count of this rank's units into ``work.cnt`` (and of
        every unit into ``work.tot`` when they differ) and the next dirty
        tails into
        ``work.next_dirty``.  Two variants per geometry: ``force_first=
        True`` (stream start / missing hold seed: segment 0 of every key is
        forced dirty) and the steady state."""
        key = self._cache_key("sparse_fused", dev, force_first)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        names, specs = self._names(), self.spec.input_specs
        cp = self.spec.change_plan
        S, q = self.spec.out_len, self.spec.out_prec
        K, n_segs = self._K, self.n_segs

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

        def prefix(work):
            seg = None
            for name in names:
                hl, n = work.hl[name], work.n[name]
                fv, fm = work.bufs[name]
                mats = sparse_compact.grid_mats(fv, fm)
                sd = sparse_compact.seg_dirty(mats, [geom[name]] * len(mats),
                                              n_segs)           # (K, n_segs)
                # buffer position 0: carried change flag (its diff partner
                # is one tick before the buffer); with no tail the carried
                # 1-tick snapshot supplies the partner
                d0 = (work.dirty[name][:, 0] if hl
                      else tick0_diff(*work.chunk(name), *work.prev[name]))
                sd = sd | (d0[:, None] & hits0[name])
                seg = sd if seg is None else seg | sd
                if hl:
                    # next dirty tail = adjacent diffs of the buffer's last
                    # hl+1 ticks (every tail position has its diff partner
                    # in the buffer, since n >= 1)
                    work.next_dirty[name].copy_(adj_diff(
                        _tm(lambda x: x[..., n - 1:n + hl], fv),
                        fm[..., n - 1:n + hl]))
            if seg is None:
                seg = torch.ones((K, n_segs), dtype=torch.bool,
                                 device=dev)    # input-free: dense
            if force_first:
                seg[:, 0] = True
            work.seg.copy_(seg)
            # the count that picks the bucket is this rank's own units'
            work.cnt.copy_(work.w.sum(dtype=torch.int32))
            if work.tot is not work.cnt:
                work.tot.copy_(work.seg.sum(dtype=torch.int32))

        cache[key] = prefix
        return prefix

    def _sparse_body(self, cap: int, dev: torch.device):
        """``body(work)``: the compacted compute of capacity ``cap`` over
        ``work.w``, into ``work.full``."""
        local = self._compute_local(cap, dev)

        def body(work):
            for o, res in local(work.w, work.bufs).items():
                _copy_tree(work.full[o], res)

        return body

    def _sparse_suffix(self, dev: torch.device):
        """The suffix of a sparse chunk, ``(suffix, after)``.  ``suffix(
        work)``: the hold fill over ``work.full``, the outputs (and the
        segment mask) packed, then the carried state written in place:
        hold seeds, dirty tails, 1-tick snapshots, tails, and the metric
        accumulators.  Local runners have no ``after`` (``None``).  On a
        mesh, ``after(work, packed)`` runs once the switched step is done
        (on the card, a graph of its own): keyed, it all-gathers the
        suffix's ``packed`` results; single-keyed, the hold fill reads
        every rank's segments, so it moves there — ``suffix`` writes the
        rest of the state, and ``after`` all-gathers the compacted outputs
        into ``work.gfull_flats``, fills, packs and writes the seeds."""
        key = self._cache_key("sparse_hold", dev)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        K, n_segs = self._K, self.n_segs
        ar = torch.arange(n_segs, device=dev)
        accum = self._obs_accum(dev)
        gathered, comm, gather = self._seg_mesh, self._comm, self._gather()

        def hold(work):
            full = work.full
            if gathered:
                for dt, f in work.full_flats.items():
                    comm.gather_flat(f, out=work.gfull_flats[dt])
                full = _unpack_merged(work.gfull_flats,
                                      work.full_packing, 0)
            full = {o: _tm(lambda x: x.reshape((K, n_segs) + x.shape[1:]),
                           f) for o, f in full.items()}
            outs, new_seeds = _hold(full, work.seg, work.seed, ar, K, n_segs)
            packed = _pack((outs, work.seg))
            for o, sd in new_seeds.items():
                _copy_tree(work.seed[o], sd)
            return packed

        def carry(work):
            for name, nd in work.next_dirty.items():
                work.dirty[name].copy_(nd)
            for name, pv in work.prev.items():
                _copy_tree(pv, _tm(lambda x: x[..., -1:], work.chunk(name)))
            work.shift()
            accum(work.mstate, work.cnt, work.tot)

        def suffix(work):
            packed = hold(work)
            carry(work)
            return packed

        if gathered:
            cache[key] = (carry, lambda work, packed: hold(work))
        elif gather is not None:
            cache[key] = (suffix, lambda work, packed: gather(packed))
        else:
            cache[key] = (suffix, None)
        return cache[key]

    def _switched(self, work: _Work, force_first: bool):
        """The captured sparse step of one variant: its prefix, then every
        capacity's body and the suffix (captured once per workspace,
        shared by both variants), composed into one graph."""
        dev = work.dev
        prefix = self._sparse_step(force_first, dev)
        caps = sparse_mod.capacity_ladder(self._Uc)
        bodies = [self._sparse_body(c, dev) for c in caps]
        suffix, after = self._sparse_suffix(dev)
        tr = self.metrics.tracer
        tr.record_capture(self._compile_label(
            self._cache_key("sparse_fused", dev, force_first)))
        with tr.span("runner.capture"):
            with tr.span("warm_up"), capture.warm_up(dev):
                self._sparse_eager(work.clone(), force_first)
            with tr.span("record"):
                pre = capture.record(lambda: prefix(work), work.pool,
                                     keep=True)
                shared = work.graphs.get("sparse_parts")
                if shared is None:
                    shared = work.graphs["sparse_parts"] = (
                        [capture.record(lambda b=b: b(work), work.pool,
                                        keep=True) for b in bodies],
                        capture.record(lambda: suffix(work), work.pool,
                                       keep=True))
                    if after is not None:
                        # replayed after the switched step, over the
                        # suffix's (static) results
                        work.graphs["sparse_after"] = capture.record(
                            lambda: after(work, shared[1].result),
                            work.pool)
                g = work.graphs[("sparse", force_first)] = capture.Switched(
                    pre, shared[0], shared[1], work.cnt, work.caps)
        return g

    def _sparse_eager(self, work: _Work, force_first: bool):
        """The sparse step's parts run one after another, without a graph,
        each in its frame.  On the CPU (the chunk path) the count is read
        on the host to pick the one capacity that runs; on the card (a
        warm-up before capture, and :meth:`staged_steps`) every
        capacity's body runs in turn, the program the switched graph holds,
        whose bucket a kernel picks on the device.  The full-capacity body
        runs last and computes every unit, so the results are the same
        (the sparse exactness contract).  A mesh step's ``after`` is a
        step (on the card a graph) of its own."""
        dev = work.dev
        with capture.frame("step"):
            with capture.frame("prefix"):
                self._sparse_step(force_first, dev)(work)
            if dev.type == "cuda":
                caps = self.capacity_ladder()
            else:
                with capture.frame("bucket-pick"):
                    caps = [sparse_mod.bucket_capacity(int(work.cnt),
                                                       self._Uc)]
            for cap in caps:
                with capture.frame(f"body[{cap}]"):
                    self._sparse_body(cap, dev)(work)
            suffix, after = self._sparse_suffix(dev)
            with capture.frame("suffix"):
                packed = suffix(work)
        if after is None:
            return packed
        with capture.frame("step"), capture.frame("after"):
            return after(work, packed)

    def _sparse_launch(self, work: _Work):
        """The sparse step's packed results (outputs and segment mask):
        eager on the CPU; on the card a replay of the switched graph of
        this chunk's variant (then of a mesh step's ``after``)."""
        st = self._sparse
        force_first = (not st["started"]) or len(self._seeded) < len(
            self.spec.out_precs)
        if work.dev.type != "cuda":
            return self._sparse_eager(work, force_first)
        g = work.graphs.get(("sparse", force_first))
        if g is None:
            g = self._switched(work, force_first)
        res = g.replay()
        after = work.graphs.get("sparse_after")
        if after is not None:
            res = after.replay()
        return res

    def _sparse_done(self, outs_seg):
        """A sparse chunk's outputs, its segment mask kept and the change
        state marked started."""
        outs, seg = outs_seg
        self.last_seg_dirty = seg
        self._sparse["started"] = True
        self._seeded = set(self.spec.out_precs)
        self._total_units += self._U
        self._chunks_run += 1
        return outs

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
        Under a mesh every rank passes the same global chunks and gets the
        whole grid back, all-gathered along the work axis (every key, every
        segment) — the global array a reference caller reads back; the
        gathers read nothing on the host, so a steady chunk makes no
        synchronizing call.
        The carried state is written only at the end of the step, after
        everything that can raise, so a raise leaves the runner as it was.
        While the tracer records, the step is the span ``runner.step``
        with its parts (:meth:`_step`), and its duration is the span's.
        """
        tr = self.metrics.tracer
        if tr.recording:
            token = tr.open("runner.step", chunk=True)
            try:
                result = self._step(chunks, tr)
            finally:
                dt = tr.close(token) / 1e9
        else:
            t0 = time.perf_counter()
            result = self._step(chunks, None)
            dt = time.perf_counter() - t0
        if self.metrics.on:
            # host-side arithmetic only (perf_counter + numpy bisect):
            # wall time around the launches, never a device read
            self._m_chunks.add(1)
            self._m_units.add(self._U)
            self._m_lat.observe(dt)
        return result["__out"] if self.spec.solo else result

    def _step(self, chunks, tr) -> dict:
        """One chunk, ``{output: grid}``.  With a recording tracer ``tr``
        each part is a span: ``ingest`` (checks, the workspace and its
        state), ``load`` (the copy-in), ``launch`` (the graph replay on the
        card, the eager step on the CPU), ``copy_out`` (the results copied
        and unpacked), ``grids`` (the output grids, the revision ring); on
        the card a chunk event before ``load`` and after ``copy_out``."""
        if tr is not None:
            tr.open("ingest")
        chunk_in = self._ingest(chunks)
        dev = self._chunk_device(chunk_in)
        work = self._live(chunk_in, dev)
        snap = None
        if self._rev_ring is not None:
            # pre-chunk tails for the revision ring: copies on the device
            # (the step rewrites the live tails in place)
            snap = {"chunk": self._t // (self.n_segs * self.spec.span),
                    "tails": _tm(lambda x: x.clone(), self._tails)}
        card = tr is not None and dev.type == "cuda"
        if tr is not None:
            tr.next("load")
            if card:
                tr.chunk_start()
        work.load(chunk_in)
        if tr is not None:
            tr.next("launch")
        if self.policy.sparse:
            packed = self._sparse_launch(work)
        else:
            packed = self._launch(work, ("dense",),
                                  self._cache_key("dense", dev),
                                  self._dense_step(dev))
        if tr is not None:
            tr.next("copy_out")
        outs = self._copy_out(work, packed)
        if self.policy.sparse:
            outs = self._sparse_done(outs)
        if tr is not None:
            if card:
                tr.chunk_end()
            tr.next("grids")
        result = {}
        for o, (v, m) in self._postprocess(outs).items():
            result[o] = SnapshotGrid(value=v, valid=m, t0=self._t,
                                     prec=self.spec.out_precs[o])
        if snap is not None:
            self._rev_ring.append(snap)
        self._t += self.n_segs * self.spec.span
        if tr is not None:
            tr.close()
        return result

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
        """Drop carried state; the next step starts a fresh stream at t=0.
        The buffers (and any captured graph over them) are kept and
        cleared in place."""
        self._obs_fold()
        if self._bound:
            _zero_tree(self._tails)
        else:
            self._tails = {}
        if self._sparse is not None:
            st = self._sparse
            for part in ("dirty", "prev", "seed"):
                if self._bound:
                    _zero_tree(st[part])
                else:
                    st[part] = {}
            st["started"] = False
            self._seeded = set()
        self._t = 0
        self.last_seg_dirty = None
        self._total_units = 0
        self._chunks_run = 0
        if self._rev_ring is not None:
            self._rev_ring.clear()

    def dirty_stats(self) -> Optional[Dict]:
        """Measured compaction of the sparse body since construction/reset:
        ``{chunks, units, dirty_units, compact}`` where ``compact`` is the
        fraction of (key × segment) work units that actually computed
        (forced-dirty first segments included).  ``None`` for dense bodies
        or before the first chunk.  Reading syncs the device-resident
        counter — a diagnostic call, not part of the steady path.  Under a
        keyed mesh it counts this rank's keys."""
        if self._sparse is None or self._total_units == 0:
            return None
        dirty = int(self._work.mstate[0])
        return {"chunks": self._chunks_run, "units": self._total_units,
                "dirty_units": dirty,
                "compact": dirty / self._total_units}

    # -- checkpointing (the one state/validate path) -------------------------
    def _strip(self, tree, host: bool = True):
        """Copies (numpy on the host, or tensors where they are), without
        the internal K axis for single-key runners: nothing a later step
        does can reach them.  A keyed mesh runner's live state (this
        rank's keys) is all-gathered into the global key layout first."""
        gather = self.policy.keyed and self._n > 1 and self._bound

        def one(x):
            x = x.detach()
            if gather:
                x = self._comm.all_gather(x, 0)
            x = x.to("cpu", copy=True).numpy() if host else x.clone()
            return x if self.policy.keyed else x[0]
        return _tm(one, tree)

    def _mine(self, tree):
        """``tree``'s leaves cut to this rank's keys where they hold every
        key (a checkpoint's global layout); the rest as they are."""
        if not (self.policy.keyed and self._n > 1):
            return tree
        k0, k1 = self._k0, self._k0 + self._K
        return _tm(lambda x: x[k0:k1] if x.shape[0] == self.n_keys else x,
                   tree)

    def _lift(self, tree):
        """Tensors copied in from a checkpoint's arrays or tensors (kept
        until the next step copies them into the runner's buffers, each
        rank its own keys' under a keyed mesh)."""
        def one(x):
            t = (x.detach().clone() if torch.is_tensor(x)
                 else torch.from_numpy(np.array(x, copy=True)))
            return t if self.policy.keyed else t[None]
        return _tm(one, tree)

    def state(self, *, host: bool = True) -> Dict:
        """Checkpointable runner state: host numpy copies, or with
        ``host=False`` tensor copies on the runner's device (a re-fit that
        stays on the card); see the module docstring for the pytree
        layout.  Under a mesh the layout is the global one, as the
        reference's: a keyed runner gathers every rank's keys (a collective
        every rank calls), a single-keyed one's state is replicated."""
        strip = lambda t: self._strip(t, host)  # noqa: E731
        out = {k: strip(v) for k, v in self._tails.items()}
        out["__t"] = self._t
        if self._sparse is not None:
            st = self._sparse
            out["__sparse"] = {
                "dirty": {k: strip(v) for k, v in st["dirty"].items()},
                "prev": {k: strip(v) for k, v in st["prev"].items()},
                "seed": {o: strip(v) for o, v in st["seed"].items()
                         if o in self._seeded or not self._bound},
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
        copied in (into the runner's buffers at the next step).
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
        lead = ((self.n_keys,) if self.policy.keyed else ())
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
        self._bound = False
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
                                                  dtype=x.dtype), tv),
                        torch.zeros((tm.shape[0], 1), dtype=torch.bool))
            self._sparse = st
            self._seeded = set(st["seed"])

    # -- late-data revision processing ---------------------------------------
    def enable_revision(self, horizon_chunks: int,
                        revise_bound: Optional[int] = None) -> None:
        """Keep a ring of the carried tails before each of the last
        ``horizon_chunks`` chunks, so sealed chunks inside the horizon can
        be revised through :meth:`revise` when late data patches their
        inputs (:meth:`repro_torch.core.plan.ChangePlan.
        revision_horizon_chunks` sizes the ring for a maximum lateness).
        ``revise_bound`` declares the maximum lateness (time units behind
        the newest stepped chunk) the ring is meant to cover; the
        ``revision`` analysis pass (:func:`repro_torch.analysis.passes.
        pass_revision`) checks it against ``revision_horizon_chunks``.

        The ring holds copies made on the device (a step rewrites the live
        tails in place), so a revisable runner reads nothing from the card
        per chunk (the reference copies its donated state to the host
        every chunk instead)."""
        if horizon_chunks < 1:
            raise ValueError("horizon_chunks must be >= 1")
        self._rev_ring = collections.deque(maxlen=int(horizon_chunks))
        self.revision_horizon = int(horizon_chunks)
        self.revise_bound = (None if revise_bound is None
                             else int(revise_bound))

    def _revision_step(self, dev: torch.device):
        """The late-data revision step ``step(work, cap, local)``:
        ``local`` is the compacted body of capacity ``cap``
        (:meth:`_compute_local`, run in the frame ``body[cap]``), never
        a dense chunk replay, over the unit mask ``work.w`` — derived on the
        host from :func:`repro_torch.core.sparse.retro_segment_mask` over
        the patched tick times, so its capacity is known without a device
        read — and no hold fill: ChangePlan dilation proves every output
        outside the dirty segments unchanged, so only dirty segments'
        output ticks are read back (clean segments carry scatter residue).
        The walked tails move to the front of the revision buffers in
        place."""
        key = self._cache_key("revise", dev)
        cache = self.spec.step_cache
        if key in cache:
            return cache[key]
        self.metrics.tracer.record_compile(self._compile_label(key))
        K, n_own = self._K, self._Uc // self._K
        gather = self._gather()

        def step(work, cap, local):
            with capture.frame(f"body[{cap}]"):
                outs = local(work.w, work.bufs)
            packed = _pack(_per_key(outs, K, n_own))
            if gather is not None:
                packed = gather(packed)
            work.shift()
            return packed

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
        ``commit=False`` is a read-only what-if replay.  On the card each
        capacity's revision step is a captured graph (one per bucket)."""
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
        results = []
        n_units = 0
        rwork = last_outs = last_sd = None
        for i, (ch, sd) in enumerate(zip(chunks, seg_dirty)):
            chunk_in = self._ingest(ch)
            dev = self._chunk_device(chunk_in)
            if rwork is None:
                rwork = self._rwork
                if (rwork is None or rwork.layout != _layout(chunk_in)
                        or rwork.dev != dev):
                    rwork = self._rwork = _Work(self, chunk_in, dev,
                                                revision=True)
                for name, dst in rwork.tails().items():
                    _copy_tree(dst, entry["tails"][name])
            else:
                # the ring entry for this chunk holds pre-patch tails —
                # refresh it with the walked (patched) ones so a later
                # revision restoring from here sees patched history
                for e in self._rev_ring:
                    if e["chunk"] == from_chunk + i:
                        e["tails"] = _tm(lambda x: x.clone(), rwork.tails())
            # this rank's keys' mask, and of it the units the rank computes
            sd = np.asarray(sd, bool).reshape(self.n_keys, self.n_segs)[
                self._k0:self._k0 + K]
            wl = sd.reshape(U)[self._u0:self._u0 + self._Uc]
            cnt = int(wl.sum())
            n_units += cnt
            # the mask is host data: its count picks the bucket without a
            # device read, and it reaches the card by an asynchronous copy
            w = torch.from_numpy(wl.copy())
            if dev.type == "cuda":
                w = w.pin_memory()
            rwork.w.copy_(w, non_blocking=True)
            rwork.load(chunk_in)
            cap = sparse_mod.bucket_capacity(cnt, self._Uc)
            rstep = self._revision_step(dev)
            local = self._compute_local(cap, dev)
            outs = self._copy_out(rwork, self._launch(
                rwork, ("revise", cap), self._cache_key("revise", dev, cap),
                lambda wk: rstep(wk, cap, local)))
            last_outs, last_sd = outs, sd
            res = {}
            for o, (v, m) in self._postprocess(outs).items():
                res[o] = SnapshotGrid(value=v, valid=m,
                                      t0=(from_chunk + i) * span,
                                      prec=self.spec.out_precs[o])
            results.append(res["__out"] if self.spec.solo else res)

        if commit and chunks:
            for name, dst in self._tails.items():
                _copy_tree(dst, rwork.tails()[name])
            if self._sparse is not None:
                st = self._sparse
                ld = torch.from_numpy(last_sd[:, -1].copy())
                if rwork.dev.type == "cuda":
                    ld = ld.pin_memory().to(rwork.dev, non_blocking=True)
                for name in self._names():
                    if self.spec.input_specs[name].left_halo:
                        # conservative: the patched tail is marked fully
                        # dirty — dirtiness only ever widens, and extra
                        # computed segments are bit-identical by the
                        # sparse exactness contract
                        st["dirty"][name].fill_(True)
                    else:
                        _copy_tree(st["prev"][name], _tm(
                            lambda x: x[..., -1:], rwork.chunk(name)))
                for o in list(self._seeded):
                    ov, om = self._mine(last_outs[o])
                    sv, sm = st["seed"][o]
                    _copy_tree(sv, _tm(
                        lambda x, s: torch.where(_bc(ld, x[..., -1]),
                                                 x[..., -1], s), ov, sv))
                    sm.copy_(torch.where(ld, om[:, -1], sm))
        if self.metrics.on:
            self._m_rev_runs.add(1)
            self._m_rev_chunks.add(len(chunks))
            self._m_rev_units.add(n_units)
        return results

    # -- ahead-of-time preparation (repro_torch.serve) -----------------------
    def example_chunks(self, device=None) -> Dict[str, SnapshotGrid]:
        """Zero-filled f32 chunks in the external :meth:`step` layout,
        sized to this runner's geometry, on ``device`` (CUDA unless
        ``"cpu"`` is asked for): what :meth:`install_executable` prepares
        steps over when no real chunk is given."""
        dev = resolve(device)
        chunks = {}
        for name in self._names():
            s = self.spec.input_specs[name]
            shape = ((self.n_keys, s.core * self.n_segs) if self.policy.keyed
                     else (s.core * self.n_segs,))
            chunks[name] = SnapshotGrid(
                value=torch.zeros(shape, dtype=torch.float32, device=dev),
                valid=torch.zeros(shape, dtype=torch.bool, device=dev),
                t0=0, prec=s.prec)
        return chunks

    def capacity_ladder(self) -> List[int]:
        """The compaction capacities this rank's compacted bodies run at
        (the per-shard ladder under a mesh)."""
        return sparse_mod.capacity_ladder(self._Uc)

    def aot_keys(self) -> List[tuple]:
        """``(label, key)`` of every step one serving process runs at this
        policy point: the variants of the chunk step, and with revision
        enabled one revision step per capacity bucket.  Enumerable without
        building anything, so a warm start can probe the persisted capture
        manifest first (:mod:`repro_torch.serve.aot`)."""
        if self.policy.sparse:
            keys = [("sparse_fused(first)", ("sparse", True)),
                    ("sparse_fused(steady)", ("sparse", False))]
        else:
            keys = [("dense", ("dense",))]
        if self._rev_ring is not None:
            keys += [(f"revise({c})", ("revise", c))
                     for c in self.capacity_ladder()]
        return keys

    def _prepare(self, work: _Work, key) -> str:
        """Build the step of ``key`` over ``work`` and, on the card,
        capture it (skipped when already captured)."""
        dev = work.dev
        kind = key[0]
        if kind == "sparse":
            if dev.type != "cuda":
                self._sparse_step(key[1], dev)
                for c in self.capacity_ladder():
                    self._sparse_body(c, dev)
                self._sparse_suffix(dev)
                return "eager"
            if key not in work.graphs:
                self._switched(work, key[1])
            return "captured"
        if kind == "dense":
            step = self._dense_step(dev)
            ckey = self._cache_key("dense", dev)
        else:
            cap = key[1]
            rstep = self._revision_step(dev)
            local = self._compute_local(cap, dev)
            step = lambda wk: rstep(wk, cap, local)  # noqa: E731
            ckey = self._cache_key("revise", dev, cap)
        if dev.type != "cuda":
            return "eager"
        self._graph(work, key, ckey, step)
        return "captured"

    def install_executable(self, key, *, label: str = "",
                           chunks: Optional[Dict] = None) -> str:
        """Prepare the step of ``key`` (one of :meth:`aot_keys`) before the
        first chunk, over the runner's live buffers for the layout of
        ``chunks`` (default :meth:`example_chunks` on CUDA): on the card
        warm it up and capture its CUDA graph, which the first real chunk
        then replays (``"captured"``); on the CPU build it
        (``"eager"``).  A CUDA graph cannot be serialized, so unlike the
        reference, which installs a deserialized executable here, the
        graph is captured anew in every process."""
        chunks = chunks if chunks is not None else self.example_chunks()
        chunk_in = self._ingest(chunks)
        dev = self._chunk_device(chunk_in)
        if key[0] == "revise":
            if self._rev_ring is None:
                raise ValueError("revision disabled — call "
                                 "enable_revision() first")
        tr = self.metrics.tracer
        with tr.span("runner.install"):
            if key[0] == "revise":
                work = self._rwork
                if work is None or work.layout != _layout(chunk_in) \
                        or work.dev != dev:
                    work = self._rwork = _Work(self, chunk_in, dev,
                                               revision=True)
            else:
                work = self._live(chunk_in, dev)
            how = self._prepare(work, key)
        tr.record_aot(label or str(key), how)
        return how

    def _staged_step(self, key, chunk_in, dev):
        """``(fn, work)``: the step of ``key`` (one of :meth:`aot_keys`) as
        a function over a scratch workspace (:meth:`_audit_state`) with
        ``chunk_in`` loaded, run eagerly in its frames when called."""
        kind = key[0]
        work = self._audit_state(chunk_in, dev, revision=kind == "revise")
        work.load(chunk_in)
        if kind == "sparse":
            return functools.partial(self._sparse_eager,
                                     force_first=key[1]), work
        if kind == "dense":
            step = self._dense_step(dev)
        else:
            cap, rstep = key[1], self._revision_step(dev)
            local = self._compute_local(cap, dev)
            step = lambda wk: rstep(wk, cap, local)  # noqa: E731

        def fn(wk):
            with capture.frame("step"):
                return step(wk)
        return fn, work

    def staged_steps(self, chunks: Optional[Dict] = None) -> List[dict]:
        """The steps one chunk runs, with concrete example arguments:
        ``[{label, key, fn, args}]``, where ``fn(*args)`` runs the step
        once, eagerly and never under a capture, over a scratch workspace
        for the layout of ``chunks`` (default :meth:`audit_example_chunks`)
        with fresh-stream state, leaving the live stream untouched; it
        returns the step's packed outputs.  A sparse step runs as
        :meth:`_sparse_eager` does on the chunks' device.  Building them
        populates the shared step cache exactly as a first chunk would."""
        chunks = chunks if chunks is not None else \
            self.audit_example_chunks()
        chunk_in = self._ingest(chunks)
        dev = self._chunk_device(chunk_in)
        steps = []
        for label, key in self.aot_keys():
            fn, work = self._staged_step(key, chunk_in, dev)
            steps.append({"label": label, "key": key, "fn": fn,
                          "args": (work,)})
        return steps

    def chunk_fn(self, variant: str = "steady",
                 chunks: Optional[Dict] = None):
        """A whole-chunk function plus concrete example args: one staged
        step and the result assembly, as :meth:`step` composes them once
        the chunk is in the workspace, over a scratch workspace
        (:meth:`staged_steps`).  ``variant``: ``"steady"`` / ``"first"``
        (sparse bodies) or ``"dense"``."""
        if self.policy.sparse:
            if variant not in ("steady", "first"):
                raise ValueError(
                    f"sparse body has chunk variants 'steady'/'first', "
                    f"not {variant!r}")
            want = ("sparse", variant == "first")
        else:
            if variant not in ("steady", "dense"):
                raise ValueError(
                    f"dense body has chunk variant 'dense', not {variant!r}")
            want = ("dense",)
        chunks = chunks if chunks is not None else \
            self.audit_example_chunks()
        chunk_in = self._ingest(chunks)
        staged, work = self._staged_step(want, chunk_in,
                                         self._chunk_device(chunk_in))

        def fn(work):
            outs = _unpack(*staged(work))
            if self.policy.sparse:
                outs = outs[0]
            return self._postprocess(outs)

        return fn, (work,)

    # -- static audit surface (repro_torch.analysis) -------------------------
    def audit_example_chunks(self, device=None) -> Dict[str, SnapshotGrid]:
        """Zero-filled example chunks in the external :meth:`step` layout,
        sized to this runner's geometry: concrete arguments for recording
        the chunk path without data.  They lie on ``device``, by default
        the runner's: its live workspace's device, else its mesh's, else
        CUDA (raising without one)."""
        if device is None:
            if self._work is not None:
                device = self._work.dev
            elif self.policy.mesh is not None:
                device = mesh_device(self.policy.mesh)
        return self.example_chunks(device)

    def _audit_state(self, chunk_in, dev, *, revision: bool = False
                     ) -> _Work:
        """A workspace with fresh-stream carried state (φ tails, dirty
        tails, snapshots and hold seeds) for ``chunk_in``'s layout on
        ``dev``, built without touching the live stream: what a step is
        recorded over.  ``revision``: a revision step's workspace."""
        if revision:
            return _Work(self, chunk_in, dev, revision=True)
        seeds = (self._zero_seeds(chunk_in, dev) if self.policy.sparse
                 else None)
        return _Work(self, chunk_in, dev, seeds=seeds)

    def seed_shape_spec(self, device=None):
        """:class:`ShapeDtype` tree of the φ hold seeds (sparse bodies;
        ``None`` for dense) — plain data, so a persisted plan artifact or
        capture manifest lets a fresh process :meth:`prime_seed_shapes`
        and skip the one evaluation of the body that sizes them (run here
        on ``device`` if no chunk has run it yet)."""
        if not self.policy.sparse:
            return None
        if self._zero_seed_cache is None:
            chunk_in = self._ingest(self.example_chunks(device))
            self._zero_seeds(chunk_in, self._chunk_device(chunk_in))
        return {o: (_tm(ShapeDtype.of, ov), ShapeDtype.of(om))
                for o, (ov, om) in self._zero_seed_cache.items()}

    def prime_seed_shapes(self, shapes) -> None:
        """Install persisted seed shapes (:meth:`seed_shape_spec` of a
        previous process), so the first sparse chunk does not evaluate the
        body to size them (only their shapes and dtypes are read)."""
        if shapes is None or not self.policy.sparse:
            return
        cpu = torch.device("cpu")
        self._zero_seed_cache = {
            o: (_tm(lambda a: a.zeros(cpu), ov), om.zeros(cpu))
            for o, (ov, om) in shapes.items()}
