"""The port's serving layer (``repro_torch.serve``) against the reference's
(``repro.serve``), as ``tests/test_serve.py`` holds the reference.

* **Ahead-of-time equivalence** — a runner whose steps are prepared ahead
  (``aot_capture``) computes the same bits as a plain runner and as the
  reference's AOT-compiled runner on the same chunks.
* **Capture manifests** — stored, loaded, and a torn one degrades to a
  miss; a missing one demotes a service to the cold path.
* **Warm start** — a second service over the same cache directory plans
  nothing and does not evaluate the body to size its seeds
  (``plan_source == "warm"``), and still computes the same bits.
* **Plan artifacts** persist across cache instances; a torn store reads
  as empty.
* **Admission ring** — the reference's five ring tests, on the port alone
  (the ring is host-only Python).
* **Event path** — one bursty arrival sequence through both packages'
  ``ServeLoop`` event paths: the same sealed chunks, bit for bit.

Here everything runs on the CPU, where the port's steps are eager; the
card's side (graphs captured ahead, a steady ``serve`` under PyTorch's
sync debug mode, no capture after warm-up) is in ``tests/
test_torch_cuda.py``.  The three ``pass_serving`` tests are mirrored (a
CPU service's steps are prepared "eager").  Not mirrored: the two
``slow`` tests of ``launch/serve.py``, the LM stack of A16.

The data is integer-valued and the query takes one mean (its sum is exact
and its one division correctly rounded in both packages), so every
comparison is exact.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import compile as rqc
from repro.core.frontend import TStream as RTStream
from repro.core.stream import Event as REvent, SnapshotGrid as RGrid
from repro.engine import ExecPolicy as RPolicy, Runner as RRunner
from repro.serve import aot_compile as r_aot_compile
from repro.serve import build_service as r_build_service
from repro_torch.analysis import audit_runner
from repro_torch.analysis.passes import pass_serving
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.core.stream import Event, SnapshotGrid
from repro_torch.engine import ExecPolicy, Runner
from repro_torch.serve import (AdmissionRing, Backpressure, ExecutableCache,
                               aot_capture, build_service, step_fingerprint)

SEG = 8          # out_len of the served runners
SPC = 2          # segments per chunk
SPAN = SEG * SPC
WIN = 8
N_CHUNKS = 5


def _query(ts=TStream):
    s = ts.source("in", prec=1)
    mu = s.window(WIN).mean().shift(1)
    return s.join(mu, lambda x, m: x - m).where(lambda e: e > 0)


def _host_chunks(n, seed=5, grid=SnapshotGrid):
    rng = np.random.default_rng(seed)
    return [{"in": grid(value=rng.integers(0, 100, SPAN).astype(np.float32),
                        valid=np.ones(SPAN, bool), t0=i * SPAN, prec=1)}
            for i in range(n)]


def _torch_chunks(n, seed=5):
    return [{"in": g["in"].replace(value=torch.from_numpy(g["in"].value),
                                   valid=torch.from_numpy(g["in"].valid))}
            for g in _host_chunks(n, seed)]


def _np(out):
    v, m = out.value, out.valid
    return ((v.numpy(), m.numpy()) if torch.is_tensor(v)
            else (np.asarray(v), np.asarray(m)))


def _assert_same(a, b):
    (va, ma), (vb, mb) = a, b
    np.testing.assert_array_equal(ma, mb)
    np.testing.assert_array_equal(va[ma], vb[mb])


def _ref_outputs(n, seed=5):
    exe = rqc.compile_query(_query(RTStream).node, out_len=SEG,
                            pallas=False, sparse=True)
    r = RRunner(exe, RPolicy(body="sparse"), segs_per_chunk=SPC)
    r_aot_compile(r)
    return [_np(r.step(c)) for c in _host_chunks(n, seed, RGrid)]


# ---------------------------------------------------------------------------
# ahead-of-time preparation
# ---------------------------------------------------------------------------

def test_aot_outputs_bit_identical():
    """Steps prepared ahead are the same computation: chunk-by-chunk
    outputs match a plain runner and the reference's AOT runner."""
    exe = qc.compile_query(_query().node, out_len=SEG, sparse=True)
    r_ref = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    r_aot = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    report = aot_capture(r_aot, device="cpu")
    assert report and all(v == "eager" for v in report.values())
    assert {label for label, _ in r_aot.aot_keys()} == set(report)
    assert set(report) == {"sparse_fused(first)", "sparse_fused(steady)"}
    want = _ref_outputs(N_CHUNKS)
    for c, w in zip(_torch_chunks(N_CHUNKS), want):
        a, b = _np(r_ref.step(c)), _np(r_aot.step(c))
        _assert_same(a, b)
        _assert_same(b, w)


@pytest.mark.parametrize("body,variant", [("dense", "dense"),
                                          ("sparse", "first"),
                                          ("sparse", "steady")])
def test_chunk_fn_and_staged_steps_match_step_and_reference(body, variant):
    """``chunk_fn`` computes one chunk as the reference's does (fresh
    stream state, bit for bit), the ``first``/``dense`` variant as
    ``Runner.step`` on a fresh stream; ``staged_steps`` covers
    ``aot_keys`` and runs each step over scratch state: the live stream
    is untouched by either."""
    chunk = _torch_chunks(2)
    rchunk = _host_chunks(1, grid=RGrid)[0]
    sparse = body == "sparse"
    exe = qc.compile_query(_query().node, out_len=SEG, sparse=sparse)
    rexe = rqc.compile_query(_query(RTStream).node, out_len=SEG,
                             pallas=False, sparse=sparse)
    r = Runner(exe, ExecPolicy(body=body), segs_per_chunk=SPC)
    r.enable_revision(2)
    fn, args = r.chunk_fn(variant, chunks=chunk[0])
    (gv, gm), = fn(*args).values()
    rfn, rargs = RRunner(rexe, RPolicy(body=body),
                         segs_per_chunk=SPC).chunk_fn(variant, chunks=rchunk)
    (wv, wm), = rfn(*rargs)[0].values()
    _assert_same((gv.numpy(), gm.numpy()), (np.asarray(wv), np.asarray(wm)))
    steps = r.staged_steps(chunk[0])
    assert [(s["label"], s["key"]) for s in steps] == r.aot_keys()
    assert any(s["key"][0] == "revise" for s in steps)
    for s in steps:
        s["fn"](*s["args"])
    fresh = Runner(exe, ExecPolicy(body=body), segs_per_chunk=SPC)
    for c in chunk:                     # the live stream starts afresh
        _assert_same(_np(r.step(c)), _np(fresh.step(c)))
    if variant != "steady":
        first = _np(Runner(exe, ExecPolicy(body=body),
                           segs_per_chunk=SPC).step(chunk[0]))
        _assert_same((gv.numpy(), gm.numpy()), first)
    with pytest.raises(ValueError):
        r.chunk_fn("dense" if sparse else "first")


def test_executable_cache_roundtrip_and_corruption(tmp_path):
    """Store → load round-trips the manifest; a torn entry degrades
    to a miss and is removed, never an error."""
    exe = qc.compile_query(_query().node, out_len=SEG, sparse=True)
    r = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    cache = ExecutableCache(str(tmp_path))
    aot_capture(r, cache, device="cpu")
    fps = [f[:-8] for f in os.listdir(tmp_path) if f.endswith(".capture")]
    assert len(fps) == len(r.aot_keys())
    assert sorted(fps) == sorted(step_fingerprint(r, label)
                                 for label, _ in r.aot_keys())
    got = cache.load(fps[0])
    assert got is not None and got["caps"] == [1, 2]
    assert got["key"] in [key for _label, key in r.aot_keys()]
    seed_v, seed_m = got["seed_shapes"]["__out"]
    assert (seed_v.shape, seed_v.dtype) == ((1,), "float32")
    assert (seed_m.shape, seed_m.dtype) == ((1,), "bool")
    with open(cache._file(fps[0]), "wb") as f:
        f.write(b"not a pickle")
    assert cache.load(fps[0]) is None
    assert not os.path.exists(cache._file(fps[0]))
    assert cache.load("missing-fingerprint") is None


# ---------------------------------------------------------------------------
# persisted warm start
# ---------------------------------------------------------------------------

def test_warm_start_planless_bit_identical(tmp_path, monkeypatch):
    """A fresh service over a warm cache directory plans nothing and sizes
    its hold seeds from the manifest — and still computes the bits of the
    cold service and of the reference's."""
    from repro_torch.core import compile as compile_mod
    from repro_torch.engine import runner as runner_mod
    cache = str(tmp_path / "svc")
    svc1 = build_service(_query(), out_len=SEG, segs_per_chunk=SPC,
                         cache_dir=cache, device="cpu")
    assert svc1.plan_source == "cold"
    outs1 = [_np(o) for o in svc1.serve(iter(_host_chunks(N_CHUNKS)))]

    def no_planning(*a, **k):
        raise AssertionError("the warm path planned")

    seeds = runner_mod.Runner._zero_seeds

    def primed_only(self, chunk_in, dev):
        assert self._zero_seed_cache is not None, "the warm path evaluated"
        return seeds(self, chunk_in, dev)

    with monkeypatch.context() as mp:
        mp.setattr(compile_mod, "plan_query", no_planning)
        mp.setattr(compile_mod, "plan_change", no_planning)
        mp.setattr(runner_mod.Runner, "_zero_seeds", primed_only)
        svc2 = build_service(_query(), out_len=SEG, segs_per_chunk=SPC,
                             cache_dir=cache, device="cpu")
        assert svc2.plan_source == "warm"
        assert all(v == "eager" for v in svc2.aot_report.values())
        outs2 = [_np(o) for o in svc2.serve(iter(_host_chunks(N_CHUNKS)))]
    ref = r_build_service(_query(RTStream), out_len=SEG, segs_per_chunk=SPC,
                          cache_dir=str(tmp_path / "ref"), jax_cache=False)
    want = [_np(o) for o in ref.serve(iter(_host_chunks(N_CHUNKS, 5,
                                                        RGrid)))]
    assert len(outs1) == len(outs2) == len(want) == N_CHUNKS
    for a, b, w in zip(outs1, outs2, want):
        _assert_same(a, b)
        _assert_same(b, w)


@pytest.mark.parametrize("fault", ["missing", "other_ladder"])
def test_warm_start_survives_missing_manifest(tmp_path, fault):
    """Deleting one persisted manifest, or one that names another
    capacity ladder than the rebuilt runner's, demotes the whole service
    to the cold path — transparently, no error — and the cold start
    writes it anew, so the next start is warm."""
    cache = str(tmp_path / "svc")
    build_service(_query(), out_len=SEG, segs_per_chunk=SPC,
                  cache_dir=cache, device="cpu")
    aot_dir = os.path.join(cache, "aot")
    victim = [f for f in os.listdir(aot_dir) if f.endswith(".capture")][0]
    if fault == "missing":
        os.remove(os.path.join(aot_dir, victim))
    else:
        store, fp = ExecutableCache(aot_dir), victim[:-len(".capture")]
        doc = store.load(fp)
        store.store(fp, dict(doc, caps=doc["caps"][:-1]))
    svc = build_service(_query(), out_len=SEG, segs_per_chunk=SPC,
                        cache_dir=cache, device="cpu")
    assert svc.plan_source == "cold"
    out = svc.step(_host_chunks(1)[0])
    assert tuple(out.valid.shape) == (SPAN,)
    assert build_service(_query(), out_len=SEG, segs_per_chunk=SPC,
                         cache_dir=cache,
                         device="cpu").plan_source == "warm"


def test_plan_artifact_persists_across_cache_instances(tmp_path):
    from repro_torch.core import ir
    from repro_torch.multiquery import SharedPlanCache
    path = str(tmp_path / "plans.pkl")
    c1 = SharedPlanCache(persist=path)
    root = c1.intern(_query().node)
    fp = ir.fingerprint(root)
    c1.store_artifact(fp, SEG, {"solo": True, "probe": 7})
    c2 = SharedPlanCache(persist=path)
    assert c2.plan_artifact(fp, SEG) == {"solo": True, "probe": 7}
    assert c2.plan_artifact(fp, SEG + 1) is None
    # a torn store degrades to empty, never an error
    with open(path, "wb") as f:
        f.write(b"\x80garbage")
    assert SharedPlanCache(persist=path).plan_artifact(fp, SEG) is None


def test_serve_counts_every_call_and_the_first_result(tmp_path):
    """The double-buffered chunk path serves every request once, in
    order, and observes each call and the first result."""
    svc = build_service(_query(), out_len=SEG, segs_per_chunk=SPC,
                        cache_dir=str(tmp_path / "svc"), device="cpu")
    outs = [_np(o) for o in svc.serve(iter(_host_chunks(8)))]
    assert len(outs) == 8
    for a, w in zip(outs, _ref_outputs(8)):
        _assert_same(a, w)
    snap = svc.runner.metrics.snapshot()
    assert snap["histograms"]["serve.call_seconds"]["count"] == 8
    assert snap["gauges"]["serve.first_result_seconds"]["value"] > 0


# ---------------------------------------------------------------------------
# admission ring
# ---------------------------------------------------------------------------

def _ev(i):
    return Event(i, i + 1, float(i))


def test_ring_fifo_and_tail_drop():
    ring = AdmissionRing(4, shed="newest")
    assert [ring.offer("in", _ev(i)) for i in range(6)] == [True] * 4 + \
        [False] * 2
    assert ring.depth == 4
    drained = ring.drain()
    assert [e.event.start for e in drained] == [0, 1, 2, 3]  # FIFO
    assert [e.t_admit for e in drained] == sorted(e.t_admit
                                                 for e in drained)
    snap = ring.metrics.snapshot()
    assert snap["counters"]["serve.admitted"]["value"] == 4
    assert snap["counters"]["serve.shed_events"]["value"] == 2
    assert snap["gauges"]["serve.ring_capacity"]["value"] == 4


def test_ring_oldest_evicts_head():
    ring = AdmissionRing(3, shed="oldest")
    assert all(ring.offer("in", _ev(i)) for i in range(5))  # always admits
    assert [e.event.start for e in ring.drain()] == [2, 3, 4]
    snap = ring.metrics.snapshot()
    assert snap["counters"]["serve.shed_events"]["value"] == 2


def test_ring_block_raises_backpressure():
    ring = AdmissionRing(2, shed="block")
    ring.offer("in", _ev(0))
    ring.offer("in", _ev(1))
    with pytest.raises(Backpressure):
        ring.offer("in", _ev(2))
    ring.drain(1)
    assert ring.offer("in", _ev(2))  # room again after a drain


def test_ring_property_bursty_random():
    """Randomized offers/drains against a plain-list model: FIFO order,
    bounded depth, offered == admitted + shed — under bursty arrival."""
    rng = np.random.default_rng(42)
    ring = AdmissionRing(8, shed="newest")
    model, drained, offered, admitted = [], [], 0, 0
    for _ in range(200):
        if rng.random() < 0.6:  # bursty: offer in runs
            for _ in range(int(rng.integers(1, 6))):
                ev = _ev(offered)
                offered += 1
                ok = ring.offer("in", ev)
                assert ok == (len(model) < 8)
                if ok:
                    model.append(ev)
                    admitted += 1
        else:
            k = int(rng.integers(1, 6))
            got = ring.drain(k)
            assert [e.event for e in got] == model[:len(got)]
            drained += [e.event.start for e in got]
            del model[:len(got)]
        assert ring.depth == len(model) <= 8
    snap = ring.metrics.snapshot()
    assert snap["counters"]["serve.admitted"]["value"] == admitted
    assert (snap["counters"]["serve.shed_events"]["value"]
            == offered - admitted)
    assert drained == sorted(drained)  # global FIFO across bursts


def test_ring_rejects_bad_args():
    with pytest.raises(ValueError):
        AdmissionRing(0)
    with pytest.raises(ValueError):
        AdmissionRing(4, shed="spill")


# ---------------------------------------------------------------------------
# event path: ring -> ingest, against the reference's, one arrival sequence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["drop", "revise"])
def test_event_path_matches_reference_bursty(tmp_path, policy):
    """One bounded-disorder bursty arrival sequence through both packages'
    serving event paths: the watermark never regresses, chunks seal in
    order, and the sealed outputs (and, with ``revise``, the corrections)
    are the reference's bit for bit."""
    svc = build_service(_query(), out_len=SEG, segs_per_chunk=SPC,
                        cache_dir=str(tmp_path / "svc"), device="cpu")
    ref = r_build_service(_query(RTStream), out_len=SEG, segs_per_chunk=SPC,
                          cache_dir=str(tmp_path / "ref"), jax_cache=False)
    for s in (svc, ref):
        s.attach_events(lateness=8, policy=policy, capacity=1024)
    svc.warm()
    T = SPAN * 6
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 100, size=T)
    # revise: some events arrive past the allowance (and are corrected)
    jit = rng.integers(0, 20 if policy == "revise" else 8, size=T)
    order = np.argsort(np.arange(T) + jit, kind="stable")
    wms, got, want = [], ([], []), ([], [])
    for burst in np.array_split(order, 40):
        for i in burst:
            assert svc.offer("in", Event(int(i), int(i) + 1,
                                         float(vals[i])))
            assert ref.offer("in", REvent(int(i), int(i) + 1,
                                          float(vals[i])))
        for acc, res in ((got, svc.pump()), (want, ref.pump())):
            acc[0].extend(res[0])
            acc[1].extend(res[1])
        wms.append(svc.ingest.tracker.watermark)
    for acc, res in ((got, svc.finish()), (want, ref.finish())):
        acc[0].extend(res[0])
        acc[1].extend(res[1])
    assert all(a <= b for a, b in zip(wms, wms[1:])), wms
    assert [s.chunk for s in got[0]] == list(range(6))
    assert [s.chunk for s in want[0]] == list(range(6))
    for g, w in zip(got[0], want[0]):
        _assert_same(_np(g.outputs), _np(w.outputs))
    assert [(c.chunk, c.version) for c in got[1]] == \
        [(c.chunk, c.version) for c in want[1]]
    if policy == "revise":
        assert got[1]
    for g, w in zip(got[1], want[1]):
        mask = np.asarray(g.seg_mask)
        assert np.array_equal(mask, np.asarray(w.seg_mask))
        tick = np.repeat(mask, SEG)
        (gv, gm), (wv, wm) = _np(g.outputs), _np(w.outputs)
        assert np.array_equal(gm[tick], wm[tick])
        assert np.array_equal(gv[tick][gm[tick]], wv[tick][wm[tick]])
    snap = svc.runner.metrics.snapshot()
    assert snap["counters"]["serve.admitted"]["value"] == T
    assert (snap["histograms"]["serve.admit_to_result_seconds"]["count"]
            > 0)


def test_event_path_declared_watermark_keys_match_reference(tmp_path):
    """``attach_events(watermark_keys=)`` reaches the watermark in both
    packages: a declared key that never sends holds every seal back until
    ``finish()``, which then seals the same chunks, bit for bit."""
    keys = [("in", 0), ("in", 1)]
    svc = build_service(_query(), out_len=SEG, segs_per_chunk=SPC,
                        cache_dir=str(tmp_path / "svc"), device="cpu")
    ref = r_build_service(_query(RTStream), out_len=SEG, segs_per_chunk=SPC,
                          cache_dir=str(tmp_path / "ref"), jax_cache=False)
    for s in (svc, ref):
        s.attach_events(lateness=4, policy="drop", watermark_keys=keys)
    vals = np.random.default_rng(2).integers(0, 100, size=SPAN * 3)
    for i, v in enumerate(vals):
        assert svc.offer("in", Event(i, i + 1, float(v)))
        assert ref.offer("in", REvent(i, i + 1, float(v)))
        assert svc.pump()[0] == [] and ref.pump()[0] == []
    got, want = svc.finish()[0], ref.finish()[0]
    assert [s.chunk for s in got] == [s.chunk for s in want] == [0, 1, 2]
    for g, w in zip(got, want):
        _assert_same(_np(g.outputs), _np(w.outputs))


# ---------------------------------------------------------------------------
# the serving analysis pass
# ---------------------------------------------------------------------------

class _RebindingRunner(Runner):
    """A runner whose steady step makes new dirty tails instead of
    writing the carried ones in place (the suffix writes into fresh
    tensors bound over them)."""

    def _sparse_suffix(self, dev):
        suffix, after = super()._sparse_suffix(dev)

        def rebinding(work):
            work.dirty = {n: torch.zeros_like(d)
                          for n, d in work.dirty.items()}
            return suffix(work)
        return rebinding, after


def _aot_runner(cls=Runner):
    exe = qc.compile_query(_query().node, out_len=SEG, sparse=True)
    r = cls(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    aot_capture(r, device="cpu")
    return r


def test_pass_serving_certifies_aot_runner():
    r = _aot_runner()
    findings = audit_runner(r, passes={"serving": pass_serving})
    assert [f.code for f in findings] == ["serving-aot-complete"], findings


def test_pass_serving_flags_missing_step_and_donation():
    r = _aot_runner()
    # a step reachable by the policy point but never prepared ahead (the
    # real-world shape: a variant enabled after warm()) -> error
    label, _key = r.aot_keys()[0]
    del r.metrics.tracer._aot[label]
    findings = audit_runner(r, passes={"serving": pass_serving})
    assert any(f.code == "serving-step-not-aot" and f.severity == "error"
               for f in findings), findings
    # a steady step that does not write its state in place -> error
    r2 = _aot_runner(_RebindingRunner)
    findings = audit_runner(r2, passes={"serving": pass_serving})
    bad = [f for f in findings if f.code == "serving-donation-missing"]
    assert bad and all(f.severity == "error" for f in bad), findings
    assert {f.target for f in bad} == {"sparse_fused(steady)"}
    assert "dirty['in'][0]:unaliased" in bad[0].provenance


def test_pass_serving_noop_on_unserved_runner():
    exe = qc.compile_query(_query().node, out_len=SEG, sparse=True)
    r = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    assert audit_runner(r, passes={"serving": pass_serving}) == []
