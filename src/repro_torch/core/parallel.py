"""Partitioned, time-sharded and keyed TiLT query execution (port of
``repro.core.parallel``).

Boundary resolution gives a per-input halo contract; this module turns it
into the one-shot execution strategies:

* :func:`partition_run` — host loop over time partitions (the paper's
  worker-thread model, one partition at a time), each fed its planned
  window of every input: ``left_halo`` lookback ticks, ``core`` fresh
  ticks, ``right_halo`` lookahead ticks, φ beyond the stream's ends.
* :func:`shard_map_run` — SPMD execution over a mesh axis, one process per
  rank: the timeline is sharded across the ranks, each keeps its own core
  slab and assembles its lookback/lookahead halo through the multi-hop
  chain planned in :mod:`.halo` (one ``batch_isend_irecv`` per hop, hop
  ``k`` forwarding the slab ``k`` neighbours over), then runs the
  partition body with no further communication — the paper's
  "synchronization-free worker", recast as SPMD — and all-gathers the
  output along the axis.
* :func:`batch_run` — keyed streams: every input carries a leading key axis
  ``(K, T)`` and the query runs once over all keys, the key axis riding
  along every tensor (and folded into the kernels' row axis).

They run on the device the input tensors live on (``shard_map_run`` on
the mesh's).  The chunked executors are :class:`repro_torch.engine.
Runner`; :class:`StreamRunner` and :class:`SparseStreamRunner` survive
here as its deprecated wrappers.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import warnings
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_leaves, tree_map

from . import compile as qcompile
from . import halo as halo_mod
from ..launch.mesh import axis_comm
from ..obs import default as _obs_default
from .stream import SnapshotGrid

__all__ = ["partition_run", "shard_map_run", "batch_run", "slice_grid",
           "StreamRunner", "SparseStreamRunner", "check_single_hop_halo",
           "place_core_inputs", "record_exchange"]

# per-CompiledQuery bound on cached (mesh, axis) SPMD steps (see
# shard_map_run)
_SHARD_STEP_CACHE_MAX = 8


def _slice_pad(value, valid, lo: int, hi: int):
    """Slice ticks [lo, hi) of a grid (time on the last axis), padding
    out-of-range ticks with φ (zero value, ``valid=False``)."""
    T = valid.shape[-1]
    lo_c, hi_c = max(lo, 0), min(hi, T)
    pad_l, pad_r = lo_c - lo, hi - hi_c

    def one(leaf):
        s = leaf[..., lo_c:max(hi_c, lo_c)]
        if pad_l or pad_r:
            s = F.pad(s, (pad_l, pad_r))
        return s

    return tree_map(one, value), one(valid)


def slice_grid(grid: SnapshotGrid, t0: int, t_end: int) -> SnapshotGrid:
    """Grid restricted to (t0, t_end]; out-of-range ticks are φ."""
    p = grid.prec
    if (t0 - grid.t0) % p or (t_end - t0) % p:
        raise ValueError(
            f"slice ({t0}, {t_end}] misaligned with grid "
            f"(t0={grid.t0}, prec={p})")
    lo = (t0 - grid.t0) // p
    hi = (t_end - grid.t0) // p
    v, m = _slice_pad(grid.value, grid.valid, lo, hi)
    return SnapshotGrid(value=v, valid=m, t0=t0, prec=p)


def _grid_window(g: SnapshotGrid, t0: int, length: int):
    # same alignment guard as slice_grid: a misaligned partition origin
    # must raise, not floor-divide into a time-shifted window
    if (t0 - g.t0) % g.prec:
        raise ValueError(
            f"partition window start {t0} misaligned with input grid "
            f"(t0={g.t0}, prec={g.prec})")
    lo = (t0 - g.t0) // g.prec
    return _slice_pad(g.value, g.valid, lo, lo + length)


def partition_run(exe: qcompile.CompiledQuery,
                  inputs: Dict[str, SnapshotGrid],
                  out_t0: int, n_parts: int,
                  interpreted: bool = False) -> SnapshotGrid:
    """Run ``n_parts`` partitions of ``exe.out_len`` output ticks each,
    starting at ``out_t0``, stitching the outputs."""
    span = exe.out_len * exe.out_prec
    outs_v, outs_m = [], []
    for k in range(n_parts):
        p0 = out_t0 + k * span
        part_in = {name: _grid_window(inputs[name], p0 + spec.t0,
                                      spec.length)
                   for name, spec in exe.input_specs.items()}
        res = (exe.run_interpreted(part_in) if interpreted
               else exe.fn(part_in))
        outs_v.append(res[0])
        outs_m.append(res[1])
    value = tree_map(lambda *xs: torch.cat(xs, dim=-1), *outs_v)
    valid = torch.cat(outs_m, dim=-1)
    return SnapshotGrid(value=value, valid=valid, t0=out_t0,
                        prec=exe.out_prec)


def check_single_hop_halo(specs: Dict[str, "qcompile.InputSpec"],
                          out_prec: int, n: int
                          ) -> Dict[str, "halo_mod.HopReport"]:
    """Report the halo/hop geometry of ``n`` time shards, per input: the
    hops each side needs and the minimum per-shard ``out_len`` at which
    the exchange collapses to a single hop.  The multi-hop chain in
    :mod:`.halo` serves any halo, so nothing is rejected."""
    report = {}
    for name, s in specs.items():
        halo = max(s.left_halo, s.right_halo)
        # single-hop needs core = out_len*out_prec // s.prec >= halo ticks
        min_out_len = -(-halo * s.prec // out_prec) if halo else 0
        report[name] = halo_mod.HopReport(
            left_hops=halo_mod.hop_count(s.left_halo, s.core) if n > 1 else 0,
            right_hops=(halo_mod.hop_count(s.right_halo, s.core)
                        if n > 1 else 0),
            min_single_hop_out_len=min_out_len)
    return report


def place_core_inputs(specs: Dict[str, "qcompile.InputSpec"],
                      inputs: Dict[str, SnapshotGrid], mesh,
                      axis: str = "data"):
    """Validate core-only input grids for time-sharded execution and keep
    this rank's slab of each: every input supplies exactly its core region
    (``n · core`` ticks, no halo) at a common origin — the global grid,
    the same on every rank — and each rank keeps only its own ``core``
    ticks, copied onto the mesh's device (the halo then comes over the hop
    chain, never from this copy of the global grid).

    ``mesh`` is a mesh (with the axis name ``axis``) or the axis's
    :class:`repro_torch.launch.mesh.AxisComm`.  Returns ``(placed,
    out_t0)``: the local ``(value, valid)`` slabs in sorted-name order and
    the absolute output start.  Shared by :func:`shard_map_run` and
    :func:`repro_torch.multiquery.shard_union_run` so the two SPMD entry
    points cannot drift on the input contract.
    """
    comm = axis_comm(mesh, axis)
    n, r = comm.n, comm.rank
    names = sorted(specs)
    t0s = {name: inputs[name].t0 for name in names}
    if len(set(t0s.values())) > 1:
        raise ValueError(
            f"inputs disagree on the core-region origin: {t0s} — every "
            "input supplies the same output-span window (P0, P0 + span]")
    out_t0 = t0s[names[0]] if names else 0
    placed = []
    for name in names:
        g, s = inputs[name], specs[name]
        if g.prec != s.prec:
            raise ValueError(
                f"input {name}: grid precision {g.prec} != planned "
                f"precision {s.prec}")
        if g.valid.shape[-1] != s.core * n:
            raise ValueError(
                f"input {name}: expected core length {s.core * n}, "
                f"got {g.valid.shape[-1]} — supply exactly the "
                "output-span region")
        lo, hi = r * s.core, (r + 1) * s.core

        def mine(x, lo=lo, hi=hi):
            return x[..., lo:hi].to(comm.device, copy=True).contiguous()

        placed.append((tree_map(mine, g.value), mine(g.valid)))
    return placed, out_t0


def record_exchange(specs: Dict[str, "qcompile.InputSpec"], placed, mesh,
                    axis: str = "data") -> None:
    """Accumulate halo-exchange telemetry for one time-sharded run into
    the default :class:`repro_torch.obs.Metrics` registry: hop counts and
    moved ticks from the static :func:`repro_torch.core.halo.exchange_cost`
    of every input's schedule, byte volume from the placed slabs' dtypes.
    Pure host arithmetic over planning artifacts — never reads device
    data.  Shared by :func:`shard_map_run` and
    :func:`repro_torch.multiquery.shard_union_run`."""
    m = _obs_default()
    n = axis_comm(mesh, axis).n
    hops = ticks = nbytes = 0
    for (v, _mk), name in zip(placed, sorted(specs)):
        cost = halo_mod.exchange_cost(specs[name].halo_schedule(), n)
        # bytes per exchanged tick: every value leaf's per-tick elements
        # plus the 1-byte validity flag
        bpt = 1 + sum(x.element_size() * math.prod(x.shape[:-1])
                      for x in tree_leaves(v))
        hops += cost["hops"]
        ticks += cost["ticks"]
        nbytes += cost["ticks"] * bpt
    m.counter("halo.runs", "time-sharded SPMD runs").add(1)
    m.counter("halo.hops", "point-to-point hops issued", "hops").add(hops)
    m.counter("halo.exchange_ticks", "halo ticks moved per shard",
              "ticks").add(ticks)
    m.counter("halo.exchange_bytes", "halo bytes moved per shard",
              "bytes").add(nbytes)


def _gather_outputs(out_specs, outs, comm):
    """All-gather along time (the last axis) every leaf of ``outs`` whose
    spec in ``out_specs`` is an axis name; a ``None`` spec keeps the leaf
    local.  ``out_specs`` is a prefix of the output's structure (dicts and
    tuples), as the reference's shard_map ``out_specs``."""
    if out_specs is None or isinstance(out_specs, str):
        if out_specs is None:
            return outs
        return tree_map(lambda x: comm.all_gather(x, -1), outs)
    if isinstance(out_specs, dict):
        return {k: _gather_outputs(out_specs[k], v, comm)
                for k, v in outs.items()}
    return type(outs)(_gather_outputs(sp, o, comm)
                      for sp, o in zip(out_specs, outs))


def stage_exchange_step(specs: Dict[str, "qcompile.InputSpec"], body,
                        mesh, axis: str, out_specs):
    """Build the SPMD step shared by both time-sharded entry points:
    assemble every input's halo through its planned hop chain
    (``InputSpec.halo_schedule`` → :func:`repro_torch.core.halo.exchange`),
    run ``body`` on the full ``{name: (value, valid)}`` grids, then
    all-gather each output leaf whose ``out_specs`` entry names the axis.
    ``step(*placed)`` takes the slabs of :func:`place_core_inputs`; every
    rank must call it (its hops and gathers are collective).  Keeping the
    construction in one place means :func:`shard_map_run` and
    :func:`repro_torch.multiquery.shard_union_run` cannot drift on it."""
    comm = axis_comm(mesh, axis)
    names = sorted(specs)
    scheds = {name: specs[name].halo_schedule() for name in names}
    _obs_default().counter(
        "halo.stagings", "SPMD exchange steps staged").add(1)

    def step(*flat):
        full = {name: halo_mod.exchange(scheds[name], v, m, comm)
                for name, (v, m) in zip(names, flat)}
        return _gather_outputs(out_specs, body(full), comm)

    return step


def _hold_variant(exe: "qcompile.CompiledQuery") -> "qcompile.CompiledQuery":
    """The minimal-``out_len`` recompile of ``exe`` used by the clean-shard
    hold body: ``m`` is the smallest output count whose span is a multiple
    of every input precision (so the variant's windows stay tick-aligned).
    Because every input's left extent (``spec.t0``) is independent of
    ``out_len``, the variant's windows are exact *prefixes* of the full
    slab — same buffer origin, so the block decompositions associate
    identically and output tick 0 is bit-identical to the full body's.
    Cached on the CompiledQuery; raises ``ValueError`` when no smaller
    variant exists."""
    if "_hold_variant" not in exe.__dict__:
        q = exe.out_prec
        m = 1
        for s in exe.input_specs.values():
            need = s.prec // math.gcd(s.prec, q)
            m = m * need // math.gcd(m, need)
        if m >= exe.out_len:
            raise ValueError(
                f"hold variant out_len {m} is not smaller than {exe.out_len}")
        exe.__dict__["_hold_variant"] = qcompile.compile_query(
            exe.root, m, opt=False, sum_algo=exe.sum_algo)
    return exe.__dict__["_hold_variant"]


def _stage_sparse_step(exe: "qcompile.CompiledQuery",
                       vexe: "qcompile.CompiledQuery", mesh, axis: str):
    """The change-compressed SPMD step ``step(flag, *placed)``: the same
    halo exchange as :func:`stage_exchange_step` (the hops stay
    unconditional — every shard takes part in every hop), then this
    shard's ``flag`` (a host bool) picks the body.  A dirty shard runs the
    full partition body; a clean one the hold body — the minimal-
    ``out_len`` variant on the slab prefix, tick 0 broadcast over the
    shard's span (a clean shard's outputs provably all equal its first
    output; see :mod:`repro_torch.core.sparse`).  The output is
    all-gathered along time."""
    comm = axis_comm(mesh, axis)
    specs = exe.input_specs
    names = sorted(specs)
    scheds = {name: specs[name].halo_schedule() for name in names}
    _obs_default().counter(
        "halo.stagings", "SPMD exchange steps staged").add(1)
    S = exe.out_len
    vspecs = vexe.input_specs

    def hold_body(full):
        pref = {name: (tree_map(lambda x, L=vspecs[name].length:
                                x[..., :L], v), m[..., :vspecs[name].length])
                for name, (v, m) in full.items()}
        ov, om = vexe.fn(pref)
        return (tree_map(lambda x: x[..., :1].expand(x.shape[:-1] + (S,)),
                         ov),
                om[..., :1].expand(om.shape[:-1] + (S,)))

    def step(flag: bool, *flat):
        full = {name: halo_mod.exchange(scheds[name], v, m, comm)
                for name, (v, m) in zip(names, flat)}
        out = exe.fn(full) if flag else hold_body(full)
        return _gather_outputs(axis, out, comm)

    return step


def lru_step_get(cache: "collections.OrderedDict", key, build,
                 max_entries: int):
    """Bounded staged-step cache: move-to-front on hit, build + evict the
    least-recently-used entries past ``max_entries`` on miss, so
    long-lived processes that re-shard across changing meshes / query sets
    stay bounded."""
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    cache[key] = hit = build()
    while len(cache) > max_entries:
        cache.popitem(last=False)
    return hit


def shard_map_run(exe: qcompile.CompiledQuery,
                  inputs: Dict[str, SnapshotGrid], mesh,
                  axis: str = "data", sparse: bool = None) -> SnapshotGrid:
    """SPMD partitioned execution: one partition per rank along ``axis``.

    Every rank calls it with the same arguments: ``inputs`` are the global
    core-only grids (no halo, one output span's worth of ticks per shard),
    of which each rank keeps its own slab (:func:`place_core_inputs`);
    every shard then assembles its full halo through the statically
    planned hop chain (``InputSpec.halo_schedule`` →
    :func:`repro_torch.core.halo.exchange`) and runs the compiled
    partition body with no further communication.  ``exe`` must be
    compiled with ``out_len == global_out_len // n``.  Returns the whole
    output grid on every rank, all-gathered along the axis; it starts
    where the inputs' core region starts (``inputs[*].t0``), so sharded
    outputs stitch against :func:`partition_run` at any origin.

    ``sparse`` selects the per-shard dirty fast path: shards whose dilated
    input lineage saw no change (the per-shard flags of
    :func:`repro_torch.core.sparse.segment_mask` through the ``seg_dirty``
    kernel, resolved on the global grids and read on the host once per
    call) skip the partition body and broadcast their locally computed
    first output tick instead — bit-identical, since a clean shard's
    outputs all equal its first output.  ``None`` (default) enables it for
    queries compiled with ``sparse=True`` when a smaller hold variant
    exists; ``True`` requires it (raising when it cannot be built);
    ``False`` forces the dense body.
    """
    comm = axis_comm(mesh, axis)
    specs = exe.input_specs
    placed, out_t0 = place_core_inputs(specs, inputs, comm)
    use_sparse = ((exe.change_plan is not None) if sparse is None
                  else bool(sparse))
    vexe = None
    if use_sparse:
        try:
            from .sparse import _change_plan
            _change_plan(exe)
            vexe = _hold_variant(exe)
        except ValueError:
            if sparse:
                raise
            use_sparse = False

    # the staged step depends only on (exe, mesh, axis, sparse) — cache it
    # on the CompiledQuery so repeated calls reuse it
    cache = exe.__dict__.setdefault("_shard_step_cache",
                                    collections.OrderedDict())
    geo = (comm.n, comm.rank, comm.serial, axis)
    if not use_sparse:
        step = lru_step_get(
            cache, geo,
            lambda: stage_exchange_step(specs, exe.fn, comm, axis,
                                        (axis, axis)),
            _SHARD_STEP_CACHE_MAX)
        record_exchange(specs, placed, comm)
        val, msk = step(*placed)
        return SnapshotGrid(value=val, valid=msk, t0=out_t0,
                            prec=exe.out_prec)

    from .sparse import segment_mask
    # per-shard flags resolve on the global grids (cross-shard lineage is
    # just index arithmetic there, no communication) — no force_first: the
    # hold body is locally self-sufficient
    flags = segment_mask(exe, inputs, out_t0, comm.n, force_first=False,
                         kernel=True)
    flag = bool(flags[comm.rank])
    step = lru_step_get(
        cache, geo + ("sparse",),
        lambda: _stage_sparse_step(exe, vexe, comm, axis),
        _SHARD_STEP_CACHE_MAX)
    record_exchange(specs, placed, comm)
    val, msk = step(flag, *placed)
    return SnapshotGrid(value=val, valid=msk, t0=out_t0, prec=exe.out_prec)


def batch_run(exe: qcompile.CompiledQuery,
              inputs: Dict[str, SnapshotGrid]) -> SnapshotGrid:
    """Keyed/partitioned-stream execution (paper §6.2's *other* parallelism
    axis): input grids carry a leading key axis ``(K, T)`` — one
    sub-stream per stock symbol / user / campaign — and the compiled query
    runs once over all keys.  Each input is φ-padded by its planned halo."""
    flat_in = {}
    for name, spec in exe.input_specs.items():
        g = inputs[name]
        hl, hr = spec.left_halo, spec.right_halo
        flat_in[name] = (tree_map(lambda x: F.pad(x, (hl, hr)), g.value),
                         F.pad(g.valid, (hl, hr)))
    val, msk = exe.fn(flat_in)
    return SnapshotGrid(value=val, valid=msk, t0=0, prec=exe.out_prec)


@dataclasses.dataclass
class StreamRunner:
    """Continuous chunked execution with carried halo state (deprecated
    alias for ``repro_torch.engine.Runner(exe, ExecPolicy())``).

    The only cross-chunk state is, per input, the trailing ``left_halo``
    ticks of the previous chunk — exactly the boundary-resolution contract.
    Queries must be lookback-only.
    """

    exe: qcompile.CompiledQuery
    _runner: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        from ..engine.policy import ExecPolicy
        from ..engine.runner import Runner
        warnings.warn(
            "StreamRunner is deprecated; use repro_torch.engine.Runner with "
            "ExecPolicy()", DeprecationWarning, stacklevel=3)
        self._runner = Runner(self.exe, ExecPolicy())

    def step(self, chunks: Dict[str, SnapshotGrid]) -> SnapshotGrid:
        """Feed exactly one partition's worth of new core ticks per input."""
        return self._runner.step(chunks)

    def state(self) -> Dict[str, tuple]:
        """Checkpointable runner state (host arrays)."""
        return self._runner.state()

    def restore(self, state: Dict) -> None:
        self._runner.restore(state, strict=False)


@dataclasses.dataclass
class SparseStreamRunner:
    """Change-compressed continuous execution (deprecated alias for
    ``repro_torch.engine.Runner(exe, ExecPolicy(body="sparse"),
    segs_per_chunk)``).

    Each step feeds ``segs_per_chunk`` partitions' worth of fresh ticks and
    only the partitions whose dilated input lineage saw a change are
    computed; the rest hold the previous output (see
    :mod:`repro_torch.core.sparse`).  The carried state is the halo
    contract plus its change metadata: dirty tails, 1-tick snapshots and
    the hold seed.  ``exe`` must be compiled with ``sparse=True``.
    """

    exe: qcompile.CompiledQuery
    segs_per_chunk: int = 8
    _runner: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        from ..engine.policy import ExecPolicy
        from ..engine.runner import Runner
        warnings.warn(
            "SparseStreamRunner is deprecated; use repro_torch.engine.Runner "
            "with ExecPolicy(body='sparse')", DeprecationWarning,
            stacklevel=3)
        if self.exe.change_plan is None:
            raise ValueError("SparseStreamRunner needs a query compiled "
                             "with sparse=True")
        self._runner = Runner(self.exe, ExecPolicy(body="sparse"),
                              segs_per_chunk=self.segs_per_chunk)

    def step(self, chunks: Dict[str, SnapshotGrid]) -> SnapshotGrid:
        """Feed ``segs_per_chunk`` partitions' worth of fresh core ticks
        per input; compute only the dirty ones."""
        return self._runner.step(chunks)

    # -- checkpointing (historical flat format, translated to the runner's
    #    state pytree) --------------------------------------------------------
    def state(self) -> Dict:
        """Checkpointable runner state (host arrays): halo tails + change
        metadata (dirty tails, 1-tick snapshots, hold seed)."""
        c = self._runner.state()
        sp = c.pop("__sparse")
        t = c.pop("__t")
        return {"tails": c, "dirty": sp["dirty"], "prev": sp["prev"],
                "seed": sp["seed"].get("__out"), "__t": t}

    def restore(self, state: Dict) -> None:
        seed = state["seed"]
        canonical = dict(state["tails"])
        canonical["__t"] = state["__t"]
        canonical["__sparse"] = {
            "dirty": state["dirty"], "prev": state["prev"],
            "seed": {} if seed is None else {"__out": seed},
            "started": True}
        self._runner.restore(canonical, strict=False)
