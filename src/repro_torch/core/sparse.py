"""Change-compressed sparse execution (paper §5's loop-counter trick); port
of ``repro.core.sparse``.

TiLT's LLVM backend skips redundant work with data-dependent loop counters:
temporal expressions are only evaluated where the underlying signal
actually *changed*.  This module recasts the trick as a **segment gather**
over the dense snapshot grids the rest of the stack uses:

1. **Dirty masks.**  Per source, :func:`source_dirty` diffs every tick's
   ``(value, valid)`` snapshot against the previous tick (the first tick
   diffs against a carried 1-tick snapshot, or is forced dirty at stream
   start).  Callers may instead supply an explicit change-event channel
   (``dirty=`` argument).
2. **Dilation.**  A changed input tick at time ``t`` can only alter outputs
   in ``[t − lookahead, t + lookback]``: :class:`repro_torch.core.plan.
   ChangePlan` derives these spans from the halo contracts.
3. **Segment compaction.**  The timeline is cut into segments of
   ``exe.out_len`` output ticks.  A segment is dirty iff any dirty input
   tick lands in its dilated lineage.  Dirty segments are gathered, with
   their full halo windows, into a compacted batch whose capacity is
   **bucketed to the next power of two** (:func:`bucket_capacity`).
4. **Compute + scatter.**  The query runs over the compacted segments only
   (segments ride along the leading axis, as keys do) and results scatter
   back; clean segments take the *hold* value — the last tick of the
   nearest preceding dirty segment, or the carried last output.

Exactness: dirty segments are computed by the same evaluator on
bit-identical inputs and clean-segment holds are implied by φ-semantics,
so sparse ≡ dense *bit-for-bit on the same partitioning* (exact for
integer-valued data across partitionings).  NaN payloads compare unequal
to themselves and are therefore always dirty.

The bucket pick: the reference picks the capacity on the device
(``searchsorted`` + ``lax.switch``).  Eager PyTorch cannot branch on device
data without reading it, so the port reads the dirty count once per call
(4 bytes, device→host) and picks the bucket with :func:`bucket_capacity`
on the host — the mechanism the reference keeps as its semantics of record
(``sparse_run(fused=False)``).  Outputs do not depend on the bucket.

Layering: this module owns the change *mechanics* (dirty masks, dilation
arithmetic, bucketing, fixed-size ids) and the one-shot :func:`sparse_run`;
the chunked runner (:mod:`repro_torch.engine.runner`) composes them with
keys.  Time is the last axis of every tensor.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from ..kernels import sparse_compact
from ..obs import default as _obs_default
from .plan import seg_range_affine
from .stream import SnapshotGrid

__all__ = ["source_dirty", "bucket_capacity", "capacity_ladder",
           "segment_mask", "sparse_run", "seg_ranges", "range_any",
           "affine_covers", "retro_segment_mask", "staged_step",
           "zero_seed", "compact_ids"]


# ---------------------------------------------------------------------------
# dirty masks
# ---------------------------------------------------------------------------

def _any_rows(neq: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Reduce a leaf's channel axes (between ``valid``'s leading axes and
    time) so the flags line up with ``valid``."""
    if neq.dim() == valid.dim():
        return neq
    return neq.reshape(valid.shape[:-1] + (-1, neq.shape[-1])).any(dim=-2)


def source_dirty(value, valid, prev: Optional[tuple] = None) -> torch.Tensor:
    """Per-tick dirty mask of one source grid (time on the last axis).

    Tick ``i`` is dirty iff its ``(value, valid)`` snapshot differs from
    tick ``i-1``'s.  ``prev`` is a 1-tick ``(value, valid)`` snapshot the
    first tick diffs against; with ``prev=None`` the first tick is
    unconditionally dirty (stream start).  Value comparison is raw —
    garbage at φ ticks counts as change — which is conservative.
    """
    if prev is None:
        pv = tree_map(lambda x: torch.zeros_like(x[..., :1]), value)
        pm = torch.zeros_like(valid[..., :1])
    else:
        pv, pm = prev
    d = valid != torch.cat([pm, valid[..., :-1]], dim=-1)
    for x, p in zip(tree_leaves(value), tree_leaves(pv)):
        neq = x != torch.cat([p.to(x.dtype), x[..., :-1]], dim=-1)
        d = d | _any_rows(neq, valid)
    if prev is None:
        d[..., 0] = True
    return d


def bucket_capacity(n: int, n_max: int) -> int:
    """Power-of-two compaction capacity ≥ ``max(n, 1)``, clipped to
    ``n_max`` — the bucketing policy that bounds the number of distinct
    batch sizes the compute ever sees."""
    return min(1 << max(n - 1, 0).bit_length(), max(n_max, 1))


def capacity_ladder(n_max: int) -> list:
    """All capacities :func:`bucket_capacity` can return for ``n_max`` work
    units, ascending: ``[1, 2, 4, ..., n_max]`` (≤ log2+1 entries)."""
    n_max = max(n_max, 1)
    caps, c = [], 1
    while c < n_max:
        caps.append(c)
        c <<= 1
    caps.append(n_max)
    return caps


def compact_ids(w: torch.Tensor, size: int, base: int = 0):
    """The compaction of the 1-D mask ``w`` into ``size`` slots, without
    reading the device: ``ids`` is ``jnp.nonzero(w, size=size,
    fill_value=0)[0] + base`` (the indices of the True entries in order,
    0-filled, offset by ``base``) and ``pos[i]`` the slot entry ``i``
    lands in, clipped to ``[0, size)`` (the scatter-back map).  One cumsum
    serves both: True entry ``i`` goes to slot ``cumsum(w)[i] - 1``; the
    rest go to a discarded slot.

    Per-shard compaction under a mesh: ``w`` is one shard's slice of the
    unit mask, ``size`` a capacity of the per-shard ladder
    (:func:`capacity_ladder` of ``U // n_shards``) and ``base`` the
    shard's first unit (``rank · U_loc``), so the ids index the replicated
    chunk buffer while the compaction stays on the shard's own units."""
    U = w.shape[0]
    pos = torch.cumsum(w, dim=0) - 1
    slot = torch.clamp(torch.where(w, pos, size), max=size)
    ids = torch.full((size + 1,), base, dtype=torch.int64, device=w.device)
    ids.scatter_(0, slot, torch.arange(base, base + U, device=w.device))
    return ids[:size], torch.clamp(pos, 0, size - 1)


# ---------------------------------------------------------------------------
# dirty-segment resolution (static index ranges + one cumsum range query)
# ---------------------------------------------------------------------------

def seg_ranges(lookback_t: int, lookahead_t: int, prec: int, grid_t0: int,
               out_t0: int, out_prec: int, seg_len: int, n_segs: int):
    """Half-open input-tick ranges ``[i_lo, i_hi1)`` per output segment: the
    input ticks whose change can dirty that segment (dilated lineage).
    Pure planning arithmetic — numpy, affine in the segment index.

    The hold rule compares each output tick to the *previous output tick*,
    one ``out_prec`` stride back, so a dirty input tick at time ``t`` can
    alter outputs ``τ`` with ``t − lookahead − prec < τ < t + lookback +
    out_prec`` — both bounds open.
    """
    k = np.arange(n_segs, dtype=np.int64)
    lo_t = out_t0 + k * seg_len * out_prec + 1 - lookback_t
    hi_t = out_t0 + (k + 1) * seg_len * out_prec + lookahead_t + prec - 1
    i_lo = -(-(lo_t - grid_t0) // prec) - 1          # ceil_index
    i_hi1 = (hi_t - grid_t0) // prec                 # floor_index + 1
    return i_lo, i_hi1


def retro_segment_mask(lookback_t: int, lookahead_t: int, prec: int,
                       out_t0: int, out_prec: int, seg_len: int,
                       n_segs: int, times) -> np.ndarray:
    """Bool per output segment: which segments of the chunk starting at
    ``out_t0`` a *retroactive* input change at tick times ``times`` can
    dirty — :func:`seg_ranges` read the other way around (late-data
    revision).  Pure host-side planning arithmetic."""
    k = np.arange(n_segs, dtype=np.int64)
    tau_min = out_t0 + k * seg_len * out_prec + out_prec
    tau_max = out_t0 + (k + 1) * seg_len * out_prec
    t = np.asarray(times, dtype=np.int64).reshape(-1, 1)
    if t.size == 0:
        return np.zeros((n_segs,), bool)
    hit = ((tau_max[None, :] > t - lookahead_t - prec)
           & (tau_min[None, :] < t + lookback_t + out_prec))
    return hit.any(axis=0)


def affine_covers(affine: tuple, i_lo, i_hi1) -> np.ndarray:
    """Does the affine lowering ``(a0, step, width)`` (the form the fused
    change-detection kernel consumes) cover the required per-segment
    ranges ``[i_lo, i_hi1)``?  A bool per segment; ``False`` means some
    input tick whose change can dirty that segment lies outside the window
    the kernel scans."""
    a0, step, width = affine
    k = np.arange(len(np.atleast_1d(i_lo)), dtype=np.int64)
    lo = a0 + k * step
    return (lo <= np.asarray(i_lo)) & (lo + width >= np.asarray(i_hi1))


def range_any(dirty: torch.Tensor, i_lo, i_hi1) -> torch.Tensor:
    """``any(dirty[i_lo[k]:i_hi1[k]])`` per segment, via one cumsum."""
    dev = dirty.device
    c = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                   torch.cumsum(dirty.to(torch.int64), dim=0)])
    L = dirty.shape[0]
    a = torch.clamp(torch.as_tensor(i_lo, device=dev), 0, L)
    b = torch.clamp(torch.as_tensor(i_hi1, device=dev), 0, L)
    return (c[b] - c[torch.minimum(a, b)]) > 0


def _starts(exe, name: str, g_t0: int, g_prec: int, out_t0: int,
            n_parts: int) -> np.ndarray:
    """Start index of every segment's halo window in the supplied grid of
    input ``name`` (may run off either end: the gather φ-pads)."""
    spec = exe.input_specs[name]
    span = exe.out_len * exe.out_prec
    if g_prec != spec.prec:
        raise ValueError(f"input {name}: grid precision {g_prec} != "
                         f"planned precision {spec.prec}")
    if (out_t0 + spec.t0 - g_t0) % spec.prec:
        raise ValueError(
            f"partition window start {out_t0 + spec.t0} misaligned with "
            f"input grid (t0={g_t0}, prec={g_prec})")
    if span % spec.prec:
        raise ValueError(
            f"input {name}: segment span {span} not a multiple of "
            f"input precision {spec.prec}")
    k = np.arange(n_parts, dtype=np.int64)
    return (out_t0 + k * span + spec.t0 - g_t0) // spec.prec


def _gather_starts(exe, inputs: Dict[str, SnapshotGrid], out_t0: int,
                   n_parts: int) -> Dict[str, torch.Tensor]:
    return {name: torch.as_tensor(
                _starts(exe, name, inputs[name].t0, inputs[name].prec,
                        out_t0, n_parts), device=inputs[name].valid.device)
            for name in exe.input_specs}


def _edge_hits(exe, name: str, g_t0: int, T: int, out_t0: int,
               n_parts: int) -> np.ndarray:
    """Segments whose dilated lineage (open interval, as in seg_ranges)
    covers one of the supplied grid's edges: beyond-grid reads are φ, so
    the φ→real transition at tick 0 and the real→φ transition one tick
    past the end are virtual changes."""
    spec, sp = exe.input_specs[name], exe.change_plan.specs[name]
    S, q = exe.out_len, exe.out_prec
    k = np.arange(n_parts, dtype=np.int64)
    tau_min = out_t0 + k * S * q + q
    tau_max = out_t0 + (k + 1) * S * q
    hit = np.zeros((n_parts,), bool)
    for t_edge in (g_t0 + spec.prec, g_t0 + (T + 1) * spec.prec):
        hit |= ((tau_max > t_edge - sp.lookahead - spec.prec)
                & (tau_min < t_edge + sp.lookback + q))
    return hit


def _affine(exe, name: str, g_t0: int, out_t0: int):
    spec, sp = exe.input_specs[name], exe.change_plan.specs[name]
    return seg_range_affine(sp.lookback, sp.lookahead, spec.prec, g_t0,
                            out_t0, exe.out_prec, exe.out_len)


def segment_mask(exe, inputs: Dict[str, SnapshotGrid], out_t0: int,
                 n_parts: int, dirty: Optional[Dict[str, torch.Tensor]] = None,
                 force_first: bool = True,
                 kernel: bool = False) -> torch.Tensor:
    """Dirty mask over ``n_parts`` output segments of ``exe.out_len`` ticks.

    ``dirty`` optionally supplies explicit per-input change masks (aligned
    to each supplied grid); otherwise masks come from :func:`source_dirty`
    on the grids themselves.  With ``force_first`` the first segment is
    always dirty (the hold-fill base case).

    ``kernel=True`` routes the value-diff inputs through the fused
    change-detection kernel (:func:`repro_torch.kernels.sparse_compact.
    seg_dirty`, the CUDA kernel on a CUDA grid and its plain version on a
    CPU one); the default keeps the staged :func:`source_dirty` +
    :func:`range_any` path.  Bit-identical either way; explicit-dirty
    inputs and non-affine lineages always take the staged path.
    """
    cp = _change_plan(exe)
    S, q = exe.out_len, exe.out_prec
    names = sorted(exe.input_specs)
    dev = (inputs[names[0]].valid.device if names else torch.device("cpu"))
    seg = torch.zeros((n_parts,), dtype=torch.bool, device=dev)
    k = np.arange(n_parts, dtype=np.int64)
    for name in names:
        spec = exe.input_specs[name]
        g = inputs[name]
        sp = cp.specs[name]
        explicit = dirty is not None and name in dirty
        if explicit or not kernel or (S * q) % spec.prec:
            d = dirty[name] if explicit else source_dirty(g.value, g.valid)
            i_lo, i_hi1 = seg_ranges(sp.lookback, sp.lookahead, spec.prec,
                                     g.t0, out_t0, q, S, n_parts)
            seg = seg | range_any(d, i_lo, i_hi1)
        else:
            a0, stp, width = _affine(exe, name, g.t0, out_t0)
            mats = sparse_compact.grid_mats(g.value, g.valid)
            seg = seg | sparse_compact.seg_dirty(
                mats, [(a0, stp, width)] * len(mats), n_parts)
            # the kernel never counts tick 0 (no diff partner); stream
            # start makes it unconditionally dirty, so the segments whose
            # dilated lineage covers index 0 flip statically
            lo = a0 + k * stp
            seg = seg | torch.as_tensor((lo <= 0) & (lo + width > 0),
                                        device=dev)
        seg = seg | torch.as_tensor(
            _edge_hits(exe, name, g.t0, g.length, out_t0, n_parts),
            device=dev)
    if not names:
        seg = torch.ones((n_parts,), dtype=torch.bool, device=dev)
    if force_first:
        seg[0] = True
    return seg


def _change_plan(exe):
    cp = getattr(exe, "change_plan", None)
    if cp is None:
        raise ValueError(
            "query was not compiled for sparse execution — pass "
            "sparse=True to compile_query to attach a ChangePlan")
    return cp


# ---------------------------------------------------------------------------
# the staged gather → batched body → scatter/hold step
# ---------------------------------------------------------------------------

def _bc(mask, x):
    """Broadcast a leading-axes mask over the trailing dims of ``x``."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def _gather_windows(exe, flat, starts, seg_ids):
    """Every selected segment's halo window of every input, φ-padded off
    the grid's ends, segments on a new leading axis."""
    gath = {}
    for name, (v, m) in zip(sorted(exe.input_specs), flat):
        L = exe.input_specs[name].length
        st = starts[name] if seg_ids is None else starts[name][seg_ids]
        idx = st[:, None] + torch.arange(L, device=m.device)[None, :]
        T = m.shape[-1]
        ok = (idx >= 0) & (idx < T)
        idxc = torch.clamp(idx, 0, T - 1)

        def gather(x, ok=ok, idxc=idxc):
            gx = torch.where(ok, x[..., idxc],               # (..., C, L)
                             torch.zeros((), dtype=x.dtype, device=x.device))
            return gx.movedim(-2, 0)                         # (C, ..., L)

        gath[name] = (tree_map(gather, v), m[idxc] & ok)
    return gath


def _stitch(x: torch.Tensor) -> torch.Tensor:
    """``(n_segs, ..., S)`` segment outputs → ``(..., n_segs·S)``."""
    x = x.movedim(0, -2)
    return x.reshape(x.shape[:-2] + (-1,))


def _step_body(exe, n_segs: int, capacity: int):
    """The staged-step closure (see :func:`staged_step` for the
    signature): compacted gather of the dirty segments, one evaluation,
    scatter back, hold fill."""

    def step(flat, starts, seg_dirty, seed_v, seed_m):
        seg_ids, pos = compact_ids(seg_dirty, capacity)
        out_v, out_m = exe.fn(_gather_windows(exe, flat, starts, seg_ids))

        # scatter compacted results back over the segment axis
        full_v = tree_map(lambda x: x.index_select(0, pos), out_v)
        full_m = out_m.index_select(0, pos)

        # hold fill: clean segments take the last tick of the nearest
        # preceding dirty segment, or the carried seed before any
        ar = torch.arange(n_segs, device=seg_dirty.device)
        prev_d = torch.cummax(torch.where(seg_dirty, ar, -1), dim=0).values
        src = torch.clamp(prev_d, 0, n_segs - 1)
        has = prev_d >= 0

        def hold(x, sv):
            hx = x[..., -1].index_select(0, src)             # (n_segs, ...)
            return torch.where(_bc(has, hx), hx, sv[None].to(x.dtype))

        hv = tree_map(hold, full_v, seed_v)
        hm = torch.where(has, full_m[:, -1].index_select(0, src), seed_m)
        ov = tree_map(lambda f, h: torch.where(_bc(seg_dirty, f), f,
                                               h.unsqueeze(-1)),
                      full_v, hv)
        om = torch.where(seg_dirty[:, None], full_m, hm[:, None])
        ov = tree_map(_stitch, ov)
        om = _stitch(om)
        return ov, om, (tree_map(lambda x: x[..., -1], ov), om[-1])

    return step


def _dense_body(exe, n_segs: int):
    """The full-capacity bucket: every segment computes.  At ``capacity ==
    n_segs`` compaction saves nothing; computing the clean segments is
    bit-identical to holding them (the module's exactness contract), so
    this returns the same bits as :func:`_step_body` without the gather,
    scatter and hold."""

    def step(flat, starts, seg_dirty, seed_v, seed_m):
        del seg_dirty, seed_v, seed_m      # every segment computes
        out_v, out_m = exe.fn(_gather_windows(exe, flat, starts, None))
        ov = tree_map(_stitch, out_v)
        om = _stitch(out_m)
        return ov, om, (tree_map(lambda x: x[..., -1], ov), om[-1])

    return step


def staged_step(exe, n_segs: int, capacity: int):
    """The sparse step for a fixed (segment count, compaction capacity)
    geometry, cached on the CompiledQuery.

    ``step(flat, starts, seg_dirty, seed_v, seed_m)`` takes the full input
    grids (``(value, valid)`` in sorted-name order), per-input segment start
    indices, the dirty-segment mask and a 1-tick hold seed; it returns the
    output ``(value, valid)`` plus the new seed (the last output tick).
    """
    cache = exe.__dict__.setdefault("_sparse_step_cache", {})
    key = (n_segs, capacity)
    if key not in cache:
        cache[key] = _step_body(exe, n_segs, capacity)
    return cache[key]


def zero_seed(exe, flat):
    """A φ hold seed shaped like one output tick (used when no carried
    output exists; the forced-dirty first segment makes it unread).  The
    shapes come from evaluating the query once on a zero input of one
    segment, on the inputs' device."""
    names = sorted(exe.input_specs)
    leaves, treedef = tree_flatten(flat)
    dev = leaves[-1].device if leaves else torch.device("cpu")
    shapes = (str(treedef), str(dev),
              tuple((tuple(x.shape), str(x.dtype)) for x in leaves))
    cache = exe.__dict__.setdefault("_sparse_seed_cache", {})
    if shapes not in cache:
        zeros = {}
        for name, (v, m) in zip(names, flat):
            L = exe.input_specs[name].length
            zeros[name] = (
                tree_map(lambda x: torch.zeros(x.shape[:-1] + (L,),
                                               dtype=x.dtype, device=dev), v),
                torch.zeros(m.shape[:-1] + (L,), dtype=torch.bool,
                            device=dev))
        out_v, _ = exe.fn(zeros)
        cache[shapes] = (tree_map(lambda a: torch.zeros_like(a[..., 0]),
                                  out_v),
                         torch.zeros((), dtype=torch.bool, device=dev))
    return cache[shapes]


# ---------------------------------------------------------------------------
# entry point: the change-compressed mirror of partition_run
# ---------------------------------------------------------------------------

def _fused_plan(exe, n_parts: int, out_t0: int, meta: tuple,
                dirty_names: tuple, dev: torch.device):
    """Everything data-independent of one fused sparse run, cached on the
    CompiledQuery per geometry and device: segment starts, the static mask
    (forced first segment, grid-edge virtual changes, stream start's
    tick 0 for value-diff inputs), kernel geometries, staged ranges."""
    cache = exe.__dict__.setdefault("_sparse_run_cache", {})
    key = (n_parts, out_t0, meta, dirty_names, str(dev))
    if key in cache:
        return cache[key]
    _obs_default().tracer.record_compile(
        f"sparse_run(n_parts={n_parts},t0={out_t0})")
    names = sorted(exe.input_specs)
    cp = _change_plan(exe)
    k = np.arange(n_parts, dtype=np.int64)
    static = np.zeros((n_parts,), bool)
    static[0] = True
    starts, geom, ranges = {}, {}, {}
    for name, (g_t0, T, g_prec) in zip(names, meta):
        starts[name] = torch.as_tensor(
            _starts(exe, name, g_t0, g_prec, out_t0, n_parts), device=dev)
        static |= _edge_hits(exe, name, g_t0, T, out_t0, n_parts)
        sp, spec = cp.specs[name], exe.input_specs[name]
        if name in dirty_names:
            i_lo, i_hi1 = seg_ranges(sp.lookback, sp.lookahead, spec.prec,
                                     g_t0, out_t0, exe.out_prec,
                                     exe.out_len, n_parts)
            ranges[name] = (torch.as_tensor(i_lo, device=dev),
                            torch.as_tensor(i_hi1, device=dev))
        else:
            a0, stp, width = _affine(exe, name, g_t0, out_t0)
            geom[name] = (a0, stp, width)
            lo = a0 + k * stp
            static |= (lo <= 0) & (lo + width > 0)
    if not names:
        static[:] = True              # input-free query: dense
    cache[key] = (starts, torch.as_tensor(static, device=dev), geom, ranges)
    return cache[key]


def sparse_run(exe, inputs: Dict[str, SnapshotGrid], out_t0: int,
               n_parts: int, dirty: Optional[Dict[str, torch.Tensor]] = None,
               fused: bool = True) -> SnapshotGrid:
    """Run ``n_parts`` partitions of ``exe.out_len`` output ticks starting
    at ``out_t0`` — the change-compressed mirror of
    :func:`repro_torch.core.parallel.partition_run`: only partitions whose
    dilated input lineage saw a change are computed; the rest hold.

    ``exe`` must be compiled with ``sparse=True``.  ``dirty`` optionally
    supplies explicit per-input change masks (one bool per tick of the
    supplied grid) in place of the value diff.

    ``fused=True`` (default) resolves the mask with the fused
    change-detection kernel (one launch per value-diff input), reads the
    dirty count once (the call's one device→host read) and runs the
    bucket's step, the dense body at full capacity.  ``fused=False`` keeps
    the three-phase staged path (:func:`segment_mask` → host-resolved
    :func:`bucket_capacity` → :func:`staged_step`), the semantics of
    record.
    """
    _change_plan(exe)
    names = sorted(exe.input_specs)
    flat = [(inputs[nm].value, inputs[nm].valid) for nm in names]
    seed_v, seed_m = zero_seed(exe, flat)
    m = _obs_default()
    m.counter("sparse.runs", "one-shot sparse_run calls").add(1)
    m.counter("sparse.segments", "segments presented to sparse_run",
              "segments").add(n_parts)
    dirty_c = m.counter("sparse.dirty_segments",
                        "segments that actually computed", "segments")
    if not fused:
        starts = _gather_starts(exe, inputs, out_t0, n_parts)
        seg_dirty = segment_mask(exe, inputs, out_t0, n_parts, dirty=dirty)
        n = int(seg_dirty.sum())
        dirty_c.add(n)
        step = staged_step(exe, n_parts, bucket_capacity(n, n_parts))
        ov, om, _ = step(flat, starts, seg_dirty, seed_v, seed_m)
        return SnapshotGrid(value=ov, valid=om, t0=out_t0,
                            prec=exe.out_prec)
    dev = flat[0][1].device if flat else seed_m.device
    meta = tuple((inputs[nm].t0, inputs[nm].length, inputs[nm].prec)
                 for nm in names)
    dnames = tuple(sorted(set(dirty or ()) & set(names)))
    starts, seg, geom, ranges = _fused_plan(exe, n_parts, out_t0, meta,
                                            dnames, dev)
    for name, (v, mk) in zip(names, flat):
        if name in dnames:
            seg = seg | range_any(dirty[name], *ranges[name])
        else:
            mats = sparse_compact.grid_mats(v, mk)
            seg = seg | sparse_compact.seg_dirty(
                mats, [geom[name]] * len(mats), n_parts)
    n = int(seg.sum())        # the one device→host read: 4 bytes
    dirty_c.add(n)
    cap = bucket_capacity(n, n_parts)
    step = (_dense_body(exe, n_parts) if cap == n_parts
            else staged_step(exe, n_parts, cap))
    ov, om, _ = step(flat, starts, seg, seed_v, seed_m)
    return SnapshotGrid(value=ov, valid=om, t0=out_t0, prec=exe.out_prec)
