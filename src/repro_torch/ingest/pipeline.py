"""Out-of-order ingestion pipeline: watermarks + reorder buffer + lateness
policy over a :class:`repro_torch.engine.runner.Runner` (port of
``repro.ingest.pipeline``).

:class:`IngestRunner` is the disorder-tolerant front end of a chunked
runner: events are :meth:`push`\\ ed in any arrival order, rasterized
eagerly by one :class:`~repro_torch.ingest.reorder.ReorderBuffer` per query
input, and :meth:`poll` seals + executes every chunk the watermark has
passed.  Events that arrive behind the sealed frontier go through the
configured lateness policy:

``drop``
    Count the late portion and discard it (the open portion, if any, is
    kept — it is not late).
``revise``
    Patch the sealed rasters (precedence-checked), mark the changed tick
    times dirty, and on the next :meth:`poll` re-run **only** the
    ChangePlan-dilated output segments through the runner's revision
    path (:meth:`Runner.revise` — the compacted sparse compute, never a
    dense chunk replay), emitting versioned :class:`Correction` rows.
``buffer``
    Re-admit the value at the sealed frontier (a one-tick event) when
    the event is entirely late; approximate by construction — sealed
    outputs are *not* corrected — but bounded and cheap.

The headline invariant (pinned in tests/test_torch_ingest.py, as
tests/test_ingest.py pins it for the reference): with ``revise``, for any
arrival permutation within the lateness bound plus revision horizon,
sealed outputs overlaid with corrections are bit-identical to in-order
execution on integer data.

Sealed grids are built on the pipeline's device (CUDA unless ``"cpu"`` is
asked for), so every chunk the runner steps, and every revision it runs,
is on the card.  Every decision is counted in the runner's ``obs`` metrics
registry under ``ingest.*``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from ..core import sparse as sparse_mod
from ..core.stream import Event
from ..obs import log_buckets
from .reorder import ReorderBuffer
from .watermark import WatermarkTracker

__all__ = ["Correction", "IngestRunner", "SealedChunk"]

_POLICIES = ("buffer", "revise", "drop")


@dataclasses.dataclass
class SealedChunk:
    """One executed chunk: the runner's output grid(s) at version 0."""

    chunk: int
    t0: int
    version: int
    outputs: Any  # output grid (solo) or {query_name: grid} (union)


@dataclasses.dataclass
class Correction:
    """A versioned revision of an already-sealed chunk's outputs.

    ``seg_mask`` flags the output segments that late data could have
    changed (ChangePlan retro-dilation); only ticks inside flagged
    segments are meaningful in ``outputs`` — everything else is provably
    unchanged from the previous version (clean segments carry scatter
    residue, not recomputed values).  Versions count up from 1 per
    chunk; consumers overlay corrections in version order.
    """

    chunk: int
    t0: int
    version: int
    seg_mask: np.ndarray  # bool (n_segs,) or (n_keys, n_segs)
    outputs: Any


class IngestRunner:
    """Disorder-tolerant ingestion front end over a chunked runner.

    Parameters
    ----------
    runner:
        The :class:`repro_torch.engine.runner.Runner` to feed.  With
        ``policy='revise'`` its revision ring is enabled here
        (:meth:`~repro_torch.engine.runner.Runner.enable_revision`) at the
        derived horizon.
    lateness:
        Bounded lateness in time units (the watermark allowance): events
        up to this far behind their key's newest event land in unsealed
        chunks.  Events later than that hit the lateness policy.
    policy:
        ``'buffer' | 'revise' | 'drop'`` (module docstring).
    horizon_chunks:
        Snapshot/raster retention depth for the revision path.  Default:
        ``ChangePlan.revision_horizon_chunks(lateness, chunk_span)`` —
        the smallest ring that guarantees any in-bound late event is
        revisable.
    watermark_keys:
        Optional declared key universe for the watermark tracker
        (strict mode — see :class:`WatermarkTracker`).
    stage:
        Optional chunk-staging hook ``{name: grid} -> handle``, applied
        when a chunk's transfer may start — the serving loop passes its
        pinned, side-stream copy to the card here (:class:`repro_torch.
        serve.ServeLoop`).  When a poll seals several chunks at once the
        next chunk is staged *before* the current one's step, so its
        transfer overlaps that step (the double-buffered data path).
        Default: identity.
    ready:
        Optional hook ``handle -> {name: grid}``, applied to a staged
        chunk just before the step that reads it (the serving loop orders
        its compute stream after that chunk's copy, and after no other).
        Default: identity.
    device:
        Where sealed grids are built: CUDA unless ``"cpu"`` is asked for
        (raises without a CUDA device otherwise).
    """

    def __init__(self, runner, *, lateness: int, policy: str = "revise",
                 horizon_chunks: Optional[int] = None, watermark_keys=None,
                 stage=None, ready=None, device=None):
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown lateness policy {policy!r} (one of {_POLICIES})")
        self.runner = runner
        self.lateness = int(lateness)
        self.policy = policy
        spec = runner.spec
        self.chunk_span = runner.n_segs * spec.span
        cp = spec.change_plan
        if horizon_chunks is None:
            if cp is not None:
                horizon_chunks = cp.revision_horizon_chunks(
                    self.lateness, self.chunk_span)
            else:
                horizon_chunks = max(
                    1, -(-(self.lateness + 1) // self.chunk_span))
        self.horizon_chunks = int(horizon_chunks)
        if policy == "revise":
            runner.enable_revision(self.horizon_chunks)
        self._stage = stage if stage is not None else (lambda c: c)
        self._ready = ready if ready is not None else (lambda c: c)
        self.tracker = WatermarkTracker(self.lateness, keys=watermark_keys)
        self._bufs = {
            name: ReorderBuffer(
                prec=s.prec, chunk_ticks=s.core * runner.n_segs,
                n_keys=runner.n_keys, keyed=runner.policy.keyed,
                horizon_chunks=self.horizon_chunks, device=device)
            for name, s in spec.input_specs.items()}
        # policy='revise' bookkeeping: patched tick times awaiting a
        # revision pass, per input per key
        self._pending: Dict[str, Dict[int, set]] = {}
        self._versions: Dict[int, int] = {}
        self._obs_init()

    # -- telemetry -----------------------------------------------------------
    def _obs_init(self) -> None:
        m = self.metrics = self.runner.metrics
        self._m_events = m.counter(
            "ingest.events", "events admitted", "events")
        self._m_late = m.counter(
            "ingest.late_events",
            "events (partially) behind the sealed frontier", "events")
        self._m_dropped = m.counter(
            "ingest.dropped_events",
            "late portions discarded (policy=drop or beyond horizon)",
            "events")
        self._m_revised = m.counter(
            "ingest.revised_events",
            "late events whose patch changed sealed ticks", "events")
        self._m_buffered = m.counter(
            "ingest.buffered_events",
            "late events re-admitted at the sealed frontier", "events")
        self._m_beyond = m.counter(
            "ingest.beyond_horizon",
            "late events refused: older than the revision horizon",
            "events")
        self._m_sealed = m.counter(
            "ingest.sealed_chunks", "chunks sealed and executed", "chunks")
        self._m_corr = m.counter(
            "ingest.corrections", "versioned correction rows emitted",
            "rows")
        self._m_lat = m.histogram(
            "ingest.lateness", log_buckets(1.0, 1e6, per_decade=1),
            "lateness of late events behind the sealed frontier",
            "time", log_scale=True)
        self._m_lag = m.gauge(
            "ingest.watermark_lag",
            "newest observed event time minus the watermark", "time")

    # -- ingest --------------------------------------------------------------
    def push(self, name: str, ev: Event, key: Optional[int] = None) -> None:
        """Admit one event for input ``name`` (sub-stream ``key`` when the
        runner is keyed), any arrival order.  Late portions go through
        the lateness policy; results surface on the next :meth:`poll`."""
        buf = self._bufs.get(name)
        if buf is None:
            raise KeyError(
                f"unknown input {name!r} (query inputs: "
                f"{sorted(self._bufs)})")
        k = 0 if key is None else int(key)
        late = buf.push(ev, k)
        on = self.metrics.on
        if on:
            self._m_events.add(1)
        if late is not None:
            a, _b = late
            frontier_t = buf.sealed_upto * buf.chunk_span
            if on:
                self._m_late.add(1)
                self._m_lat.observe(max(1, frontier_t - (a + 1) * buf.prec))
            if self.policy == "drop":
                if on:
                    self._m_dropped.add(1)
            elif self.policy == "revise":
                times, beyond = buf.patch(ev, k)
                if beyond:
                    if on:
                        self._m_beyond.add(1)
                        self._m_dropped.add(1)
                elif times.size:
                    if on:
                        self._m_revised.add(1)
                    self._pending.setdefault(name, {}).setdefault(
                        k, set()).update(int(t) for t in times)
            else:  # buffer: re-time a fully-late event to the frontier
                if on:
                    self._m_buffered.add(1)
                if ev.end <= frontier_t:
                    buf.push(Event(frontier_t, frontier_t + buf.prec,
                                   ev.payload), k)
        self.tracker.observe(ev.end, key=(name, k))
        if on:
            lag = self.tracker.lag()
            if lag is not None:
                self._m_lag.set(lag)

    def heartbeat(self, t: int) -> None:
        """Advance every observed key's clock to ``t`` (empty
        punctuation): lets the watermark pass quiet spans so chunks seal
        without new data."""
        self.tracker.heartbeat(t)

    # -- execution -----------------------------------------------------------
    def _execute(self, rows, names) -> list:
        """Step a batch of sealed chunk rows, double-buffered through the
        staging hooks: chunk i+1 is staged (its copy to the card issued,
        when the hooks are the serving loop's) before chunk i's step, and
        chunk i's step waits for chunk i's copy only, so transfer and
        compute overlap."""
        def stage(row):
            return self._stage({n: g for n, (_c, g) in zip(names, row)})

        sealed = []
        nxt = stage(rows[0]) if rows else None
        for i, row in enumerate(rows):
            c = row[0][0]
            cur = nxt
            nxt = stage(rows[i + 1]) if i + 1 < len(rows) else None
            out = self.runner.step(self._ready(cur))
            sealed.append(SealedChunk(
                chunk=c, t0=c * self.chunk_span, version=0, outputs=out))
        return sealed

    def poll(self) -> tuple:
        """Run pending revisions, then seal + execute every chunk the
        watermark has passed.  Returns ``(sealed, corrections)`` — lists
        of :class:`SealedChunk` / :class:`Correction`, in order.

        Revisions run *before* sealing: the runner's revision commit must
        extend through its newest stepped chunk, so patched history is
        folded in first and freshly sealed chunks then compute on it."""
        corrections = self._run_revisions()
        sealed = []
        wm = self.tracker.watermark
        if wm is not None:
            per_input = {name: buf.seal_ready(wm)
                         for name, buf in self._bufs.items()}
            names = sorted(per_input)
            sealed = self._execute(
                list(zip(*(per_input[n] for n in names))), names)
            if self.metrics.on and sealed:
                self._m_sealed.add(len(sealed))
        return sealed, corrections

    def flush(self) -> tuple:
        """End of stream: run pending revisions, then seal every chunk
        any event wrote (watermark notwithstanding) and execute them.
        Returns ``(sealed, corrections)`` like :meth:`poll`."""
        corrections = self._run_revisions()
        target = max((buf.last_chunk for buf in self._bufs.values()),
                     default=-1)
        sealed = []
        if target >= 0:
            per_input = {name: buf.seal_all(target)
                         for name, buf in self._bufs.items()}
            names = sorted(per_input)
            sealed = self._execute(
                list(zip(*(per_input[n] for n in names))), names)
            if self.metrics.on and sealed:
                self._m_sealed.add(len(sealed))
        return sealed, corrections

    def _run_revisions(self) -> list:
        """Fold every pending late patch into one revision walk: restore
        the earliest patched chunk's snapshot, re-run the
        ChangePlan-dilated segments of every chunk from there through the
        newest stepped one (committing the patched state), and emit one
        :class:`Correction` per chunk that had dirty segments."""
        if not self._pending:
            return []
        runner = self.runner
        span = self.chunk_span
        cur = runner._t // span
        K, n_segs = runner.n_keys, runner.n_segs
        cp = runner.spec.change_plan
        all_times = [t for per_key in self._pending.values()
                     for ts in per_key.values() for t in ts]
        c_first = min((t - 1) // span for t in all_times)
        chunks, masks = [], []
        for c in range(c_first, cur):
            # the patched grids go through the staging hooks too, so a
            # served runner revises on its own device
            chunks.append(self._stage({name: buf.sealed_grid(c)
                                       for name, buf in self._bufs.items()}))
            mask = np.zeros((K, n_segs), bool)
            for name, per_key in self._pending.items():
                if cp is None:
                    mask[:] = True  # no plan: conservatively all-dirty
                    continue
                sp = cp.specs[name]
                for k, ts in per_key.items():
                    mask[k] |= sparse_mod.retro_segment_mask(
                        sp.lookback, sp.lookahead, sp.prec,
                        c * span, cp.out_prec, cp.out_len, n_segs,
                        sorted(ts))
            masks.append(mask if runner.policy.keyed else mask[0])
        outs = runner.revise(c_first, [self._ready(ch) for ch in chunks],
                             masks, commit=True)
        corrections = []
        for i, out in enumerate(outs):
            mk = np.asarray(masks[i]).reshape(K, n_segs)
            if not mk.any():
                continue
            c = c_first + i
            v = self._versions.get(c, 0) + 1
            self._versions[c] = v
            corrections.append(Correction(
                chunk=c, t0=c * span, version=v,
                seg_mask=np.asarray(masks[i]), outputs=out))
        self._pending = {}
        if self.metrics.on and corrections:
            self._m_corr.add(len(corrections))
        return corrections
