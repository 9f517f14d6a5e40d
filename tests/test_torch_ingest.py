"""The port's out-of-order ingestion (``repro_torch.ingest``) and the
runner's late-data revision, as ``tests/test_ingest.py`` holds the
reference, plus the port against the reference on one arrival sequence.

The headline invariant: for any arrival permutation within the lateness
bound plus revision horizon, sealed outputs overlaid with the emitted
corrections are bit-identical to in-order execution on integer data —
unkeyed and keyed, with event spans and change dilations crossing segment
and chunk boundaries (window lookback 24 over 16-tick chunks).  Also: the
reorder buffer reproduces ``events_to_grid`` under any arrival order, patch
precedence and horizon refusal, the revision re-run is the compacted body
(only dilated segments compute, no chunk is re-stepped), the drop and
buffer policies, the lateness histogram, and ``restore(strict=False)``.
The ``revision`` analysis pass (undersized, covered and undeclared
horizons; ``IngestRunner``'s derived horizon passes it) and the donation
pass over the revision steps are mirrored too.  Not mirrored: the
reference's jaxpr and transfer guard checks of the staged revision step
(the port's revision reads nothing from the card:
``tests/test_torch_cuda.py`` counts it).

Every comparison is exact: the data is integer-valued.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import compile as rqc
from repro.core.frontend import TStream as RTStream
from repro.core.stream import Event as REvent
from repro.engine import ExecPolicy as RPolicy, Runner as RRunner
from repro.ingest import IngestRunner as RIngestRunner
from repro_torch.analysis import make_target
from repro_torch.analysis.passes import pass_donation, pass_revision
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.core.sparse import retro_segment_mask
from repro_torch.core.stream import (Event, EventStream, SnapshotGrid,
                                     events_to_grid)
from repro_torch.engine import ExecPolicy, Runner
from repro_torch.ingest import IngestRunner, ReorderBuffer, WatermarkTracker

SEG = 8    # output ticks per segment
SPC = 2    # segments per chunk
CHUNK = SEG * SPC  # chunk span (out_prec = 1)

_EXE_CACHE = {}


def _query(ts, keyed=False):
    s = ts.source("in", prec=1, keyed=keyed)
    return (s.window(4).mean()
            .join(s.window(24).mean(), lambda a, b: a - b))


def _exe(keyed: bool = False):
    """Join of a short and a long window: the 24-tick lookback dilates
    late changes across segment AND chunk boundaries (chunk = 16)."""
    if keyed not in _EXE_CACHE:
        _EXE_CACHE[keyed] = qc.compile_query(
            _query(TStream, keyed).node, out_len=SEG, sparse=True)
    return _EXE_CACHE[keyed]


def _grid(events, n):
    return events_to_grid(EventStream(events), 0, n, 1, device="cpu")


def _int_events(rng, t_end: int, gap: bool = False) -> list:
    """Contiguous (or gapped) integer-payload events covering (0, t_end];
    the final one-tick event pins coverage of the last chunk."""
    events, t = [], 0
    while t < t_end - 1:
        d = int(rng.integers(1, 6))
        if not (gap and rng.random() < 0.2):
            events.append(Event(t, min(t + d, t_end - 1),
                                float(rng.integers(0, 10))))
        t += d
    events.append(Event(t_end - 1, t_end, float(rng.integers(0, 10))))
    return events


def _shuffled(rng, tagged, disorder: int):
    """Bounded-disorder arrival order: sort by start + jitter in [0, D)."""
    jit = rng.integers(0, max(disorder, 1), size=len(tagged))
    order = np.argsort([ev.start + j for (_k, ev), j in zip(tagged, jit)],
                       kind="stable")
    return [tagged[i] for i in order]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _overlay(sealed, corrections, keyed: bool = False):
    """Fold corrections (version order) into the sealed outputs: only
    ticks inside dirty segments are taken from a correction."""
    final = {}
    for sc in sealed:
        final[sc.chunk] = (_np(sc.outputs.value), _np(sc.outputs.valid))
    for co in sorted(corrections, key=lambda c: (c.chunk, c.version)):
        v, m = final[co.chunk]
        ov, om = _np(co.outputs.value), _np(co.outputs.valid)
        mask = np.asarray(co.seg_mask)
        tick = (np.repeat(mask, SEG, axis=1) if keyed
                else np.repeat(mask, SEG))
        final[co.chunk] = (np.where(tick, ov, v), np.where(tick, om, m))
    return final


def _assert_chunks_match(final, ref, n_chunks: int, keyed: bool = False):
    refv, refm = _np(ref.value), _np(ref.valid)
    assert sorted(final) == list(range(n_chunks))
    for c in range(n_chunks):
        v, m = final[c]
        sl = (Ellipsis, slice(c * CHUNK, (c + 1) * CHUNK))
        wv, wm = refv[sl], refm[sl]
        assert np.array_equal(m, wm), f"chunk {c}: validity differs"
        assert np.array_equal(v[m], wv[wm]), f"chunk {c}: values differ"


def _drive(ing, arrivals):
    sealed, corrections = [], []
    for name, ev, key in arrivals:
        ing.push(name, ev, key=key)
        s, c = ing.poll()
        sealed += s
        corrections += c
    s, c = ing.flush()
    return sealed + s, corrections + c


def _sparse_runner(keyed=False, n_keys=None):
    return Runner(_exe(keyed), ExecPolicy(body="sparse",
                                          keys="vmapped" if keyed
                                          else "single"),
                  n_keys=n_keys, segs_per_chunk=SPC)


# ---------------------------------------------------------------------------
# watermark semantics
# ---------------------------------------------------------------------------

def test_watermark_tracker_semantics():
    wt = WatermarkTracker(lateness=5)
    assert wt.watermark is None and wt.frontier is None
    wt.observe(20, key="a")
    assert wt.frontier == 20 and wt.watermark == 15
    wt.observe(40, key="b")
    # the slowest key holds the stream back
    assert wt.frontier == 20 and wt.high == 40 and wt.lag() == 25
    wt.observe(10, key="a")  # per-key max is monotonic
    assert wt.frontier == 20
    wt.heartbeat(50)
    assert wt.frontier == 50 and wt.watermark == 45
    # declared key universe: strict — silent keys gate the watermark
    ws = WatermarkTracker(lateness=0, keys=["x", "y"])
    ws.observe(9, key="x")
    assert ws.watermark is None
    ws.observe(3, key="y")
    assert ws.watermark == 3
    with pytest.raises(KeyError):
        ws.observe(1, key="z")
    with pytest.raises(ValueError):
        WatermarkTracker(lateness=-1)


# ---------------------------------------------------------------------------
# reorder buffer ≡ events_to_grid under any arrival permutation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dict_payload", [False, True])
def test_reorder_buffer_matches_events_to_grid_any_order(dict_payload):
    rng = np.random.default_rng(11)
    T, CT = 64, 16
    events = []
    seen = set()
    for _ in range(40):  # overlapping spans, distinct (start, end)
        s = int(rng.integers(0, T - 1))
        e = min(T, s + int(rng.integers(1, 8)))
        if e <= s or (s, e) in seen:
            continue
        seen.add((s, e))
        p = float(rng.integers(0, 100))
        events.append(Event(s, e, {"x": p, "y": -p} if dict_payload else p))
    stream = EventStream(events)
    buf = ReorderBuffer(prec=1, chunk_ticks=CT, horizon_chunks=1,
                        device="cpu")
    order = rng.permutation(len(events))  # fully arbitrary arrival
    for i in order:
        assert buf.push(events[i]) is None  # nothing sealed yet: never late
    sealed = buf.seal_all()
    assert [c for c, _ in sealed] == [0, 1, 2, 3]
    for c, got in sealed:
        want = events_to_grid(stream, c * CT, (c + 1) * CT, 1, device="cpu")
        assert torch.equal(got.valid, want.valid)
        gv = got.value if dict_payload else {"v": got.value}
        wv = want.value if dict_payload else {"v": want.value}
        assert gv.keys() == wv.keys()
        for k in gv:
            assert gv[k].dtype == wv[k].dtype == torch.float32
            assert torch.equal(gv[k], wv[k])


def test_reorder_patch_precedence_and_horizon_refusal():
    buf = ReorderBuffer(prec=1, chunk_ticks=8, horizon_chunks=2,
                        device="cpu")
    buf.push(Event(0, 32, 1.0))
    buf.seal_all()  # chunks 0..3 sealed; rasters retained for 2, 3
    assert buf.sealed_upto == 4
    # later-starting event wins at its ticks; change reported as times
    times, beyond = buf.patch(Event(26, 28, 9.0))
    assert not beyond and list(times) == [27, 28]
    g = buf.sealed_grid(3)
    assert g.value[[2, 3]].tolist() == [9.0, 9.0]
    # a losing event (same start, earlier end than the owner) changes nothing
    times, beyond = buf.patch(Event(26, 27, 5.0))
    assert not beyond and times.size == 0
    # a patch reaching past the horizon is refused WHOLE
    times, beyond = buf.patch(Event(10, 27, 5.0))
    assert beyond and times.size == 0
    assert float(buf.sealed_grid(3).value[0]) == 1.0
    with pytest.raises(KeyError):
        buf.sealed_grid(1)  # evicted


@pytest.mark.parametrize("keyed", [False, True])
def test_sealed_grid_does_not_alias_its_raster(keyed):
    """A sealed grid is a copy: a late event that patches the raster
    afterwards changes what ``sealed_grid`` rebuilds, never the grid the
    runner was already handed (the reference hands its live validity
    raster to the step, ROADMAP C9)."""
    K = 2 if keyed else 1
    buf = ReorderBuffer(prec=1, chunk_ticks=8, n_keys=K, keyed=keyed,
                        horizon_chunks=2, device="cpu")
    for k in range(K):
        buf.push(Event(0, 3, 1.0), k)
        buf.push(Event(5, 16, 2.0), k)
    (c0, g0), (c1, _g1) = buf.seal_all()
    assert (c0, c1) == (0, 1)
    v0, m0 = g0.value.clone(), g0.valid.clone()
    assert not bool(m0[..., 3:5].any())            # the hole before patching
    times, beyond = buf.patch(Event(3, 5, 7.0), K - 1)
    assert not beyond and list(times) == [4, 5]
    assert torch.equal(g0.value, v0) and torch.equal(g0.valid, m0)
    patched = buf.sealed_grid(0)
    assert patched.valid[..., 3:5].reshape(K, 2)[K - 1].all()
    assert patched.value[..., 3:5].reshape(K, 2)[K - 1].tolist() == [7., 7.]


# ---------------------------------------------------------------------------
# disorder-insensitivity (the headline invariant)
# ---------------------------------------------------------------------------

def test_in_bound_disorder_needs_no_revisions():
    """Permutations within the watermark allowance: the reorder buffer
    alone restores order — zero late events and zero corrections."""
    rng = np.random.default_rng(0)
    n_chunks, disorder = 6, 6
    events = _int_events(rng, n_chunks * CHUNK, gap=True)
    ref = _sparse_runner().run({"in": _grid(events, n_chunks * CHUNK)},
                               n_chunks)
    r = _sparse_runner()
    ing = IngestRunner(r, lateness=disorder + 6, policy="revise",
                       device="cpu")
    arrivals = [("in", ev, None) for _k, ev in
                _shuffled(rng, [(0, e) for e in events], disorder)]
    sealed, corrections = _drive(ing, arrivals)
    assert corrections == []
    snap = r.metrics.snapshot()["counters"]
    assert snap["ingest.late_events"]["value"] == 0
    assert snap["ingest.sealed_chunks"]["value"] == n_chunks
    _assert_chunks_match(_overlay(sealed, corrections), ref, n_chunks)


def test_late_data_revision_exactness():
    """Disorder past the watermark allowance: late events patch sealed
    rasters and sparse revisions correct the outputs — sealed +
    corrections ≡ in-order execution, bit-identical."""
    rng = np.random.default_rng(1)
    n_chunks, disorder, lateness = 6, 24, 4
    events = _int_events(rng, n_chunks * CHUNK)
    ref = _sparse_runner().run({"in": _grid(events, n_chunks * CHUNK)},
                               n_chunks)
    r = _sparse_runner()
    ing = IngestRunner(r, lateness=lateness, policy="revise",
                       horizon_chunks=4, device="cpu")
    arrivals = [("in", ev, None) for _k, ev in
                _shuffled(rng, [(0, e) for e in events], disorder)]
    sealed, corrections = _drive(ing, arrivals)
    snap = r.metrics.snapshot()["counters"]
    assert snap["ingest.revised_events"]["value"] > 0
    assert snap["ingest.beyond_horizon"]["value"] == 0
    assert snap["ingest.dropped_events"]["value"] == 0
    assert len(corrections) > 0
    for co in corrections:  # versions count up from 1 per chunk
        assert co.version >= 1 and np.asarray(co.seg_mask).any()
    _assert_chunks_match(_overlay(sealed, corrections), ref, n_chunks)


def _keyed_full(per_key, n):
    grids = [_grid(evs, n) for evs in per_key]
    return SnapshotGrid(value=torch.stack([g.value for g in grids]),
                        valid=torch.stack([g.valid for g in grids]),
                        t0=0, prec=1)


def test_late_data_revision_exactness_keyed():
    """Keyed variant: per-key sub-streams shuffled together; a slow key
    gates sealing through the per-key watermark, revisions dirty only
    the patched keys' segments."""
    K, n_chunks, disorder, lateness = 4, 4, 20, 4
    rng = np.random.default_rng(2)
    per_key = [_int_events(rng, n_chunks * CHUNK) for _ in range(K)]
    ref = _sparse_runner(True, K).run(
        {"in": _keyed_full(per_key, n_chunks * CHUNK)}, n_chunks)
    r = _sparse_runner(True, K)
    ing = IngestRunner(r, lateness=lateness, policy="revise",
                       horizon_chunks=4, device="cpu")
    tagged = [(k, ev) for k, evs in enumerate(per_key) for ev in evs]
    arrivals = [("in", ev, k) for k, ev in _shuffled(rng, tagged, disorder)]
    sealed, corrections = _drive(ing, arrivals)
    snap = r.metrics.snapshot()["counters"]
    assert snap["ingest.revised_events"]["value"] > 0
    assert snap["ingest.beyond_horizon"]["value"] == 0
    assert len(corrections) > 0
    # keyed dirtiness: at least one correction leaves some key untouched
    assert any(not np.asarray(co.seg_mask).all(axis=1).all()
               for co in corrections)
    _assert_chunks_match(_overlay(sealed, corrections, keyed=True), ref,
                         n_chunks, keyed=True)


# ---------------------------------------------------------------------------
# the revision re-run is the compacted sparse body, not a dense replay
# ---------------------------------------------------------------------------

def test_revision_is_compacted(monkeypatch):
    exe = _exe()
    r = _sparse_runner()
    r.enable_revision(3)
    rng = np.random.default_rng(7)
    events = _int_events(rng, 3 * CHUNK)
    grid = _grid(events, 3 * CHUNK)
    r.run({"in": grid}, 3)
    before = r.metrics.snapshot()["counters"]["runner.chunks"]["value"]

    # patch chunk 1's LAST tick: its first segment stays clean (the
    # retro-dilation reaches backward only lookahead+prec), later
    # segments across the chunk boundary go dirty
    v, m = grid.value.clone(), grid.valid.clone()
    v[2 * CHUNK - 1] += 1.0
    t_patch = 2 * CHUNK  # tick index 2·CHUNK−1 lives at time 2·CHUNK

    def _chunk(c):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        return SnapshotGrid(value=v[sl], valid=m[sl], t0=c * CHUNK, prec=1)

    cp, sp = exe.change_plan, exe.change_plan.specs["in"]
    masks = [retro_segment_mask(sp.lookback, sp.lookahead, sp.prec,
                                c * CHUNK, cp.out_prec, cp.out_len, SPC,
                                [t_patch]) for c in (1, 2)]
    assert masks[0].any() and not all(mk.all() for mk in masks)
    computed = []
    orig = Runner._compute_local
    monkeypatch.setattr(Runner, "_compute_local", lambda self, cap, dev: (
        computed.append(cap), orig(self, cap, dev))[1])
    outs = r.revise(1, [{"in": _chunk(1)}, {"in": _chunk(2)}], masks)
    monkeypatch.undo()

    snap = r.metrics.snapshot()["counters"]
    assert snap["runner.chunks"]["value"] == before  # no chunk re-stepped
    assert snap["runner.revision_runs"]["value"] == 1
    assert snap["runner.revision_chunks"]["value"] == 2
    n_units = sum(int(mk.sum()) for mk in masks)
    assert snap["runner.revision_units"]["value"] == n_units
    assert n_units < 2 * SPC  # compute-cap: strictly fewer than all units
    # each chunk computed its dirty units' bucket, not all SPC units
    assert computed == [1 << max(int(mk.sum()) - 1, 0).bit_length()
                        for mk in masks]
    assert min(computed) < SPC

    # dirty-segment outputs match a from-scratch run on the patched data
    ref = _sparse_runner().run(
        {"in": SnapshotGrid(value=v, valid=m, t0=0, prec=1)}, 3)
    for i, c in enumerate((1, 2)):
        tick = torch.from_numpy(np.repeat(masks[i], SEG))
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        gm = outs[i].valid[tick]
        assert torch.equal(gm, ref.valid[sl][tick])
        assert torch.equal(outs[i].value[tick][gm],
                           ref.value[sl][tick][gm])


def test_revise_validates_ring_and_extent():
    r = _sparse_runner()
    with pytest.raises(ValueError, match="revision disabled"):
        r.revise(0, [], [])
    r.enable_revision(2)
    rng = np.random.default_rng(9)
    grid = _grid(_int_events(rng, 4 * CHUNK), 4 * CHUNK)
    r.run({"in": grid}, 4)

    def _chunk(c):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        return SnapshotGrid(value=grid.value[sl], valid=grid.valid[sl],
                            t0=c * CHUNK, prec=1)

    mk = np.ones(SPC, bool)
    with pytest.raises(ValueError, match="beyond the horizon"):
        r.revise(0, [{"in": _chunk(c)} for c in range(4)], [mk] * 4)
    with pytest.raises(ValueError, match="newest stepped chunk"):
        r.revise(2, [{"in": _chunk(2)}], [mk])  # stops short of chunk 3
    with pytest.raises(ValueError, match="one seg_dirty mask"):
        r.revise(2, [{"in": _chunk(2)}, {"in": _chunk(3)}], [mk])
    with pytest.raises(ValueError, match="horizon_chunks"):
        r.enable_revision(0)


# ---------------------------------------------------------------------------
# lateness policies + horizon refusal at the pipeline level
# ---------------------------------------------------------------------------

def _held_back_scenario(policy, lateness=2, horizon=1, seed=3):
    """Push everything in order except one early event held to the end."""
    rng = np.random.default_rng(seed)
    n_chunks = 4
    events = _int_events(rng, n_chunks * CHUNK)
    held = events[2]  # fully inside chunk 0
    assert held.end <= CHUNK
    rest = [e for i, e in enumerate(events) if i != 2]
    r = _sparse_runner()
    ing = IngestRunner(r, lateness=lateness, policy=policy,
                       horizon_chunks=horizon, device="cpu")
    arrivals = ([("in", e, None) for e in rest]
                + [("in", held, None)])  # arrives after chunk 0 sealed
    sealed, corrections = _drive(ing, arrivals)
    ref = _sparse_runner().run({"in": _grid(rest, n_chunks * CHUNK)},
                               n_chunks)
    return r, sealed, corrections, ref, n_chunks


def test_beyond_horizon_patch_refused_and_counted():
    r, sealed, corrections, ref, n = _held_back_scenario(
        "revise", lateness=2, horizon=1, seed=3)
    snap = r.metrics.snapshot()["counters"]
    assert snap["ingest.beyond_horizon"]["value"] == 1
    assert snap["ingest.dropped_events"]["value"] == 1
    # refused whole: outputs equal the in-order run WITHOUT that event
    _assert_chunks_match(_overlay(sealed, corrections), ref, n)


def test_policy_drop_discards_and_counts():
    r, sealed, corrections, ref, n = _held_back_scenario("drop")
    snap = r.metrics.snapshot()["counters"]
    assert snap["ingest.dropped_events"]["value"] == 1
    assert snap["ingest.late_events"]["value"] == 1
    assert corrections == []
    _assert_chunks_match(_overlay(sealed, corrections), ref, n)


def test_policy_buffer_readmits_and_counts():
    r, sealed, corrections, _ref, n = _held_back_scenario("buffer")
    snap = r.metrics.snapshot()["counters"]
    assert snap["ingest.buffered_events"]["value"] == 1
    assert corrections == []  # buffer never revises sealed outputs
    assert len(sealed) == n


def test_lateness_histogram_and_lag_gauge():
    r, *_ = _held_back_scenario("revise", horizon=4)
    snap = r.metrics.snapshot()
    assert snap["histograms"]["ingest.lateness"]["count"] == 1
    assert snap["gauges"]["ingest.watermark_lag"]["value"] >= 0


def test_unknown_policy_and_input_raise():
    with pytest.raises(ValueError, match="lateness policy"):
        IngestRunner(_sparse_runner(), lateness=2, policy="later",
                     device="cpu")
    ing = IngestRunner(_sparse_runner(), lateness=2, device="cpu")
    with pytest.raises(KeyError, match="unknown input"):
        ing.push("nope", Event(0, 1, 1.0))


def test_default_horizon_is_the_change_plan_formula():
    cp = _exe().change_plan
    r = _sparse_runner()
    ing = IngestRunner(r, lateness=40, policy="revise", device="cpu")
    assert ing.horizon_chunks == cp.revision_horizon_chunks(40, CHUNK)
    assert r.revision_horizon == ing.horizon_chunks


# ---------------------------------------------------------------------------
# analysis: revision-horizon coverage pass
# ---------------------------------------------------------------------------

def test_revision_pass_flags_undersized_horizon():
    exe = _exe()
    cp = exe.change_plan
    r = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    assert pass_revision(make_target(r)) == []  # disabled: not applicable
    r.enable_revision(1, revise_bound=10 * CHUNK)
    fs = pass_revision(make_target(r))
    assert [f.code for f in fs] == ["revision-horizon-undersized"]
    assert fs[0].severity == "error" and fs[0].pass_name == "revision"

    need = cp.revision_horizon_chunks(16, SPC * SEG)
    r2 = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    r2.enable_revision(need, revise_bound=16)
    fs2 = pass_revision(make_target(r2))
    assert [f.code for f in fs2] == ["revision-horizon-covered"]
    assert fs2[0].severity == "info"

    r3 = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    r3.enable_revision(2)
    fs3 = pass_revision(make_target(r3))
    assert [f.code for f in fs3] == ["revision-bound-undeclared"]


def test_ingest_runner_default_horizon_satisfies_pass():
    """IngestRunner's derived horizon is the ChangePlan formula and it
    declares its lateness as the bound, so the pass is green by
    construction; every revision step writes its tails in place."""
    r = Runner(_exe(), ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    IngestRunner(r, lateness=40, policy="revise", device="cpu")
    assert r.revise_bound == 40
    fs = pass_revision(make_target(r))
    assert [f.code for f in fs] == ["revision-horizon-covered"]
    target = make_target(r, device="cpu")
    assert any(s["key"][0] == "revise" for s in target.staged())
    assert pass_donation(target) == []


def test_retro_span_and_horizon_arithmetic():
    cp = _exe().change_plan
    sp = cp.specs["in"]
    lo, hi = cp.retro_span("in", 10, 10)
    assert lo == 10 - sp.lookahead - sp.prec
    assert hi == 10 + sp.lookback + cp.out_prec
    slack = sp.lookahead + sp.prec
    assert cp.revision_horizon_chunks(CHUNK - slack, CHUNK) == 1
    assert cp.revision_horizon_chunks(CHUNK, CHUNK) == 2
    assert cp.revision_horizon_chunks(0, CHUNK) == 1
    mask_next = retro_segment_mask(sp.lookback, sp.lookahead, sp.prec,
                                   CHUNK, cp.out_prec, cp.out_len, SPC,
                                   [CHUNK - 2])
    assert mask_next[0]  # lookback 24 reaches into the following chunk
    assert retro_segment_mask(sp.lookback, sp.lookahead, sp.prec, 0,
                              cp.out_prec, cp.out_len, SPC, []).sum() == 0


# ---------------------------------------------------------------------------
# Runner.restore(strict=False) φ-re-init
# ---------------------------------------------------------------------------

def test_restore_strict_false_phi_reinit_matches_uninterrupted():
    """A checkpoint missing one (halo-free) input φ-re-inits its change
    lineage: the next chunk's first segment is forced dense and the
    continuation stays bit-identical."""
    s1 = TStream.source("a", prec=1)
    s2 = TStream.source("b", prec=1)
    q = s1.window(8).mean().join(s2, lambda x, y: x + y)
    exe = qc.compile_query(q.node, out_len=SEG, sparse=True)
    assert exe.input_specs["b"].left_halo == 0  # raw source: halo-free
    n_chunks = 5
    T = n_chunks * CHUNK

    def _pw(seed):
        rr = np.random.default_rng(seed)
        change = rr.random(T) < 0.1
        change[0] = True
        raw = np.floor(rr.random(T) * 50).astype(np.float32)
        vals = raw[np.maximum.accumulate(np.where(change, np.arange(T), -1))]
        return torch.from_numpy(vals)

    ga, gb = _pw(10), _pw(11)
    ok = torch.ones(T, dtype=torch.bool)

    def _chunks(c):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        return {"a": SnapshotGrid(value=ga[sl], valid=ok[sl],
                                  t0=c * CHUNK, prec=1),
                "b": SnapshotGrid(value=gb[sl], valid=ok[sl],
                                  t0=c * CHUNK, prec=1)}

    def runner():
        return Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)

    r1 = runner()
    for c in range(3):
        r1.step(_chunks(c))
    st = r1.state()
    ref = [r1.step(_chunks(c)) for c in (3, 4)]

    st_no_prev = {**st, "__sparse": {**st["__sparse"],
                                     "prev": dict(st["__sparse"]["prev"]),
                                     "dirty": dict(st["__sparse"]["dirty"])}}
    del st_no_prev["__sparse"]["prev"]["b"]
    r2 = runner()
    with pytest.raises(ValueError, match="prev"):
        r2.restore(st_no_prev, strict=True)
    st_missing = dict(st_no_prev)
    del st_missing["b"]
    del st_missing["__sparse"]["dirty"]["b"]
    r2.restore(st_missing, strict=False)
    assert r2._t == 3 * CHUNK
    got = [r2.step(_chunks(c)) for c in (3, 4)]
    r3 = runner()
    r3.restore(st_missing, strict=False)
    r3.step(_chunks(3))
    assert r3.last_seg_dirty[:, 0].all()
    for g, w in zip(got, ref):
        assert torch.equal(g.valid, w.valid)
        assert torch.equal(g.value[g.valid], w.value[w.valid])


# ---------------------------------------------------------------------------
# property: random bounded permutations
# ---------------------------------------------------------------------------

def test_property_bounded_disorder_is_invisible():
    """Random event streams, random bounded arrival permutations, random
    lateness allowances: sealed outputs + revisions are always
    bit-identical to in-order execution."""
    hypothesis = pytest.importorskip("hypothesis")
    given, settings, st = (hypothesis.given, hypothesis.settings,
                           hypothesis.strategies)
    n_chunks = 5

    @settings(max_examples=8, deadline=None, database=None)
    @given(seed=st.integers(0, 2**31 - 1),
           disorder=st.sampled_from([0, 3, 9, 18, 27]),
           lateness=st.sampled_from([0, 3, 8]))
    def check(seed, disorder, lateness):
        rng = np.random.default_rng(seed)
        events = _int_events(rng, n_chunks * CHUNK, gap=True)
        ref = _sparse_runner().run({"in": _grid(events, n_chunks * CHUNK)},
                                   n_chunks)
        r = _sparse_runner()
        # horizon 4 chunks (64 time units) covers disorder+maxdur ≤ 33
        ing = IngestRunner(r, lateness=lateness, policy="revise",
                           horizon_chunks=4, device="cpu")
        arrivals = [("in", ev, None) for _k, ev in
                    _shuffled(rng, [(0, e) for e in events], disorder)]
        sealed, corrections = _drive(ing, arrivals)
        snap = r.metrics.snapshot()["counters"]
        assert snap["ingest.beyond_horizon"]["value"] == 0
        _assert_chunks_match(_overlay(sealed, corrections), ref, n_chunks)

    check()


# ---------------------------------------------------------------------------
# the port's IngestRunner against the reference's, one arrival sequence
# ---------------------------------------------------------------------------

def _settled(res):
    """The reference's ``poll()``/``flush()`` result once the device work
    behind it has finished.  Its reorder buffer hands the live numpy
    validity raster to the jitted step without a copy (ROADMAP C9), so a
    later ``push`` that patches the raster can race JAX's asynchronous
    dispatch; waiting here, before the next push, takes the race out of
    the comparison."""
    sealed, corrections = res
    jax.block_until_ready([(x.outputs.value, x.outputs.valid)
                           for x in list(sealed) + list(corrections)])
    return res


@pytest.mark.parametrize("keyed", [False, True])
def test_ingest_runner_matches_reference(keyed):
    """One arrival sequence, late events and all, into both packages'
    IngestRunners: the same sealed chunks (index, t0, outputs) and the same
    corrections (chunk, version, segment mask, outputs in the dirty
    segments), bit for bit."""
    K = 3 if keyed else 1
    n_chunks, disorder, lateness = 5, 24, 4
    rng = np.random.default_rng(21)
    per_key = [_int_events(rng, n_chunks * CHUNK) for _ in range(K)]
    tagged = [(k, ev) for k, evs in enumerate(per_key) for ev in evs]
    order = _shuffled(rng, tagged, disorder)

    rexe = rqc.compile_query(_query(RTStream, keyed).node, out_len=SEG,
                             pallas=False, sparse=True)
    rpol = RPolicy(body="sparse", keys="vmapped" if keyed else "single")
    ring = RIngestRunner(RRunner(rexe, rpol, n_keys=K if keyed else None,
                                 segs_per_chunk=SPC),
                         lateness=lateness, policy="revise",
                         horizon_chunks=4)
    ing = IngestRunner(_sparse_runner(keyed, K if keyed else None),
                       lateness=lateness, policy="revise", horizon_chunks=4,
                       device="cpu")
    got, want = ([], []), ([], [])
    for k, ev in order:
        key = k if keyed else None
        ing.push("in", ev, key=key)
        ring.push("in", REvent(ev.start, ev.end, ev.payload), key=key)
        for acc, res in ((got, ing.poll()), (want, _settled(ring.poll()))):
            acc[0].extend(res[0])
            acc[1].extend(res[1])
    for acc, res in ((got, ing.flush()), (want, _settled(ring.flush()))):
        acc[0].extend(res[0])
        acc[1].extend(res[1])

    assert [s.chunk for s in got[0]] == [s.chunk for s in want[0]]
    assert len(got[0]) == n_chunks
    for g, w in zip(*[x[0] for x in (got, want)]):
        assert (g.t0, g.version) == (w.t0, w.version)
        gm, wm = _np(g.outputs.valid), np.asarray(w.outputs.valid)
        assert np.array_equal(gm, wm)
        assert np.array_equal(_np(g.outputs.value)[gm],
                              np.asarray(w.outputs.value)[wm])
    assert len(got[1]) == len(want[1]) > 0
    for g, w in zip(got[1], want[1]):
        assert (g.chunk, g.t0, g.version) == (w.chunk, w.t0, w.version)
        assert np.array_equal(g.seg_mask, np.asarray(w.seg_mask))
        tick = np.repeat(np.asarray(g.seg_mask), SEG, axis=-1)
        gm = _np(g.outputs.valid)[tick]
        assert np.array_equal(gm, np.asarray(w.outputs.valid)[tick])
        assert np.array_equal(_np(g.outputs.value)[tick][gm],
                              np.asarray(w.outputs.value)[tick][gm])
    for name in ("ingest.late_events", "ingest.revised_events",
                 "ingest.corrections", "runner.revision_units"):
        assert (ing.metrics.snapshot()["counters"][name]["value"]
                == ring.metrics.snapshot()["counters"][name]["value"]), name


@pytest.mark.parametrize("declared", [False, True])
def test_watermark_keys_match_reference(declared):
    """``watermark_keys=`` declares the watermark's key universe in both
    packages: a key that has sent nothing holds every seal back (strict
    mode), one that is not declared is refused.  One arrival sequence in
    which key 2 starts late: the same chunks seal after the same pushes,
    with the same outputs, bit for bit."""
    K, n_chunks = 3, 4
    rng = np.random.default_rng(23)
    per_key = [_int_events(rng, n_chunks * CHUNK) for _ in range(K)]
    first = [(k, ev) for k in (0, 1) for ev in per_key[k]]
    order = (sorted(first, key=lambda kv: kv[1].start)
             + [(2, ev) for ev in per_key[2]])
    keys = [("in", k) for k in range(K)] if declared else None
    rexe = rqc.compile_query(_query(RTStream, True).node, out_len=SEG,
                             pallas=False, sparse=True)
    ring = RIngestRunner(RRunner(rexe, RPolicy(body="sparse",
                                               keys="vmapped"),
                                 n_keys=K, segs_per_chunk=SPC),
                         lateness=4, policy="revise", watermark_keys=keys)
    ing = IngestRunner(_sparse_runner(True, K), lateness=4, policy="revise",
                       watermark_keys=keys, device="cpu")
    got, want = [], []
    for i, (k, ev) in enumerate(order):
        ing.push("in", ev, key=k)
        ring.push("in", REvent(ev.start, ev.end, ev.payload), key=k)
        got += [(i, s) for s in ing.poll()[0]]
        want += [(i, s) for s in _settled(ring.poll())[0]]
    assert [(i, s.chunk) for i, s in got] == [(i, s.chunk) for i, s in want]
    n_first = len(first)
    if declared:
        assert got and got[0][0] >= n_first      # key 2 gated every seal
    else:
        assert got and got[0][0] < n_first
    for (_i, g), (_j, w) in zip(got, want):
        gm, wm = _np(g.outputs.valid), np.asarray(w.outputs.valid)
        assert np.array_equal(gm, wm)
        assert np.array_equal(_np(g.outputs.value)[gm],
                              np.asarray(w.outputs.value)[wm])
    if declared:
        with pytest.raises(KeyError):
            ing.push("in", Event(0, 1, 1.0), key=3)


def test_staging_hooks_stage_ahead_and_ready_before_each_step():
    """When one poll seals several chunks, ``stage`` is applied to chunk
    i+1 before chunk i's step and ``ready`` to chunk i just before its
    step (so a served step waits for its own copy only), and revision
    chunks pass through both hooks before ``revise``."""
    log = []
    r = _sparse_runner()
    step, revise = r.step, r.revise

    def t0(chunks):
        return chunks["in"].t0

    def logged_step(chunks):
        log.append(("step", t0(chunks)))
        return step(chunks)

    def logged_revise(c_first, chunks, masks, **kw):
        log.append(("revise", [t0(c) for c in chunks]))
        return revise(c_first, chunks, masks, **kw)

    r.step, r.revise = logged_step, logged_revise
    ing = IngestRunner(
        r, lateness=0, policy="revise", horizon_chunks=4, device="cpu",
        stage=lambda c: log.append(("stage", t0(c))) or ("handle", c),
        ready=lambda h: log.append(("ready", t0(h[1]))) or h[1])
    rng = np.random.default_rng(4)
    events = _int_events(rng, 3 * CHUNK)
    for ev in events:
        ing.push("in", ev)
    sealed, _ = ing.poll()
    assert [s.chunk for s in sealed] == [0, 1, 2]
    a, b = CHUNK, 2 * CHUNK
    assert log == [("stage", 0), ("stage", a), ("ready", 0), ("step", 0),
                   ("stage", b), ("ready", a), ("step", a), ("ready", b),
                   ("step", b)]
    log.clear()
    ing.push("in", Event(2, 3, 99.0))          # late: patches chunk 0
    _, corrections = ing.poll()
    assert corrections
    assert log == [("stage", 0), ("stage", a), ("stage", b), ("ready", 0),
                   ("ready", a), ("ready", b), ("revise", [0, a, b])]
