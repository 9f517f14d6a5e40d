"""The runner's hot-path guarantees, as ``tests/test_runner_hotpath.py``
holds the reference's, where the CPU can show them.

* **State in place** (the reference's donation): a runner steps in
  buffers allocated once; every carried tensor — halo tails, dirty tails,
  hold seeds, the 1-tick ``prev`` snapshots of halo-free inputs, the
  metric accumulators — keeps its storage across steady chunks, and the
  state dicts are views of it.
* ``restore`` copies the checkpoint in, and ``state`` copies out: steps
  that rewrite the buffers in place never reach arrays a caller holds.
* One step build per (policy, geometry) key across repeated chunks, the
  same keys for a second runner being no builds at all.
* ``Metrics.reset_after_warmup`` re-bases the accumulators in place (a
  captured step holds their addresses).

Each case also holds the port's outputs against the reference runner's on
the same integer-valued chunks, bit for bit.  Not mirrored: the
reference's ``transfer_guard`` and ``is_deleted`` checks, which are JAX's
(the card's counterpart — zero synchronizing calls in a steady chunk — is
``tests/test_torch_cuda.py``'s), and the static audit of the policy
lattice (ROADMAP A15).
"""
import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro.core import compile as rqc
from repro.core.frontend import TStream as RTStream
from repro.core.stream import SnapshotGrid as RGrid
from repro.engine import ExecPolicy as RPolicy, Runner as RRunner
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.core.stream import SnapshotGrid
from repro_torch.engine import ExecPolicy, Runner

SEG = 32
SPC = 4
SPAN = SEG * SPC


def _query(ts, keyed=False):
    s = ts.source("in", prec=1, keyed=keyed)
    return (s.window(16).mean()
            .join(s.window(32).mean(), lambda a, b: a - b)
            .where(lambda d: d > 0))


def _exe(sparse=True):
    return qc.compile_query(_query(TStream).node, out_len=SEG, sparse=sparse)


def _ref_runner(body="sparse"):
    exe = rqc.compile_query(_query(RTStream).node, out_len=SEG,
                            pallas=False, sparse=body == "sparse")
    return RRunner(exe, RPolicy(body=body), segs_per_chunk=SPC)


def _vals(n_chunks, seed):
    """A piecewise-constant integer stream, so compaction happens."""
    rng = np.random.default_rng(seed)
    n = n_chunks * SPAN
    change = rng.random(n) < 0.03
    change[0] = True
    raw = np.floor(rng.random(n) * 100).astype(np.float32)
    return raw[np.maximum.accumulate(np.where(change, np.arange(n), -1))]


def _chunks(n_chunks, seed, grid=SnapshotGrid, wrap=torch.from_numpy):
    vals = _vals(n_chunks, seed)
    return [{"in": grid(value=wrap(vals[c * SPAN:(c + 1) * SPAN].copy()),
                        valid=wrap(np.ones(SPAN, bool)), t0=c * SPAN,
                        prec=1)} for c in range(n_chunks)]


def _same(port, ref):
    pm, rm = port.valid.numpy(), np.asarray(ref.valid)
    assert np.array_equal(pm, rm)
    assert np.array_equal(port.value.numpy()[pm], np.asarray(ref.value)[rm])


def _state_ptrs(r):
    st = r._sparse or {"dirty": {}, "seed": {}, "prev": {}}
    leaves = tree_leaves((r._tails, st["dirty"], st["seed"], st["prev"]))
    if r._work is not None and r._work.sparse:
        leaves += list(r._work.mstate)
    return [x.untyped_storage().data_ptr() for x in leaves]


def test_steady_sparse_chunks_keep_their_buffers():
    r = Runner(_exe(), ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    ref = _ref_runner()
    chunks, rchunks = _chunks(5, 9), _chunks(5, 9, RGrid, np.asarray)
    for c, rc in zip(chunks[:2], rchunks[:2]):
        _same(r.step(c), ref.step(rc))
    ptrs = _state_ptrs(r)
    assert ptrs and len(set(ptrs)) >= 2
    for c, rc in zip(chunks[2:], rchunks[2:]):
        _same(r.step(c), ref.step(rc))
        assert _state_ptrs(r) == ptrs
    stats = r.dirty_stats()
    assert stats["chunks"] == 5 and stats["dirty_units"] < stats["units"]


def test_dense_step_keeps_its_tails():
    r = Runner(_exe(sparse=False), ExecPolicy(), segs_per_chunk=SPC)
    ref = _ref_runner("dense")
    chunks, rchunks = _chunks(3, 1), _chunks(3, 1, RGrid, np.asarray)
    _same(r.step(chunks[0]), ref.step(rchunks[0]))
    ptrs = _state_ptrs(r)
    for c, rc in zip(chunks[1:], rchunks[1:]):
        _same(r.step(c), ref.step(rc))
        assert _state_ptrs(r) == ptrs


def test_prev_snapshots_exist_for_halo_free_inputs_only_and_stay_put():
    """1-tick ``prev`` snapshots are kept exactly for halo-free inputs
    (their change detection reads them), updated in place, and hold the
    input's last tick for the next chunk to diff against."""
    a = TStream.source("a", prec=1)
    b = TStream.source("b", prec=1)
    q = a.window(16).mean().join(b, lambda m, x: x - m)
    exe = qc.compile_query(q.node, out_len=SEG, sparse=True)
    assert exe.input_specs["a"].left_halo > 0
    assert exe.input_specs["b"].left_halo == 0
    r = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    rng = np.random.default_rng(17)

    def chunk(c):
        return {nm: SnapshotGrid(
            value=torch.from_numpy(
                np.floor(rng.random(SPAN) * 10).astype(np.float32)),
            valid=torch.ones(SPAN, dtype=torch.bool), t0=c * SPAN, prec=1)
            for nm in ("a", "b")}

    chunks = [chunk(c) for c in range(4)]
    r.step(chunks[0])
    r.step(chunks[1])
    assert list(r._sparse["prev"]) == ["b"]
    ptr = r._sparse["prev"]["b"][0].data_ptr()
    r.step(chunks[2])
    assert r._sparse["prev"]["b"][0].data_ptr() == ptr
    assert torch.equal(r._sparse["prev"]["b"][0].reshape(-1),
                       chunks[2]["b"].value[-1:])
    r.step(chunks[3])


def test_exactly_one_build_per_policy_geometry_key():
    """Every step-cache key is built once across repeated chunks: the two
    sparse prefixes, the capacity buckets' compute bodies, the hold fill
    and the metric accumulator; a second runner builds nothing."""
    exe = _exe()
    r = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    for c in _chunks(6, 21):
        r.step(c)
    counts = r.metrics.snapshot()["compiles"]["counts"]
    assert any(k.startswith("sparse_fused(") for k in counts), counts
    assert any(k.startswith("compute(") for k in counts), counts
    assert any(k.startswith("sparse_hold(") for k in counts), counts
    assert any(k.startswith("obs_accum(") for k in counts), counts
    assert all(n == 1 for n in counts.values()), counts
    assert r.metrics.snapshot()["compiles"]["retraces"] == {}
    r2 = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    for c in _chunks(6, 21):
        r2.step(c)
    assert r2.metrics.snapshot()["compiles"]["counts"] == {}


def test_warmup_reset_rebases_metrics_in_place():
    """``Metrics.reset_after_warmup()`` re-bases the latency histogram,
    the chunk counters and the device accumulators — in place, so the
    buffers a captured step writes stay the ones the registry reads — and
    keeps the build record."""
    r = Runner(_exe(), ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    chunks = _chunks(4, 31)
    r.step(chunks[0])
    r.step(chunks[1])
    ptrs = _state_ptrs(r)
    r.metrics.reset_after_warmup()
    snap = r.metrics.snapshot()
    assert snap["counters"]["runner.chunks"]["value"] == 0
    assert snap["counters"]["runner.dirty_units"]["value"] == 0
    assert snap["histograms"]["runner.step_seconds"]["count"] == 0
    assert any(k.startswith("sparse_fused(")
               for k in snap["compiles"]["counts"])
    r.step(chunks[2])
    assert _state_ptrs(r) == ptrs
    snap = r.metrics.snapshot()
    assert snap["counters"]["runner.chunks"]["value"] == 1
    assert snap["histograms"]["runner.step_seconds"]["count"] == 1
    assert sum(snap["vectors"]["runner.bucket_picks"]["values"]) == 1
    assert (snap["counters"]["runner.dirty_units"]["value"]
            == r.dirty_stats()["dirty_units"])
    assert r.dirty_stats()["chunks"] == 1
    r.step(chunks[3])


def test_restore_copies_state_out_of_the_buffers_reach():
    """restore() copies the checkpoint into the runner's buffers and
    state() copies out of them: the steps that rewrite the buffers in
    place never reach arrays the caller holds, and a restored runner
    continues as the original (and as the reference) does."""
    r1 = Runner(_exe(), ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    ref = _ref_runner()
    chunks = _chunks(4, 13)
    rchunks = _chunks(4, 13, RGrid, np.asarray)
    for c, rc in zip(chunks[:2], rchunks[:2]):
        r1.step(c)
        ref.step(rc)
    ckpt = r1.state()
    held = [np.array(x, copy=True) for x in tree_leaves(ckpt)
            if isinstance(x, np.ndarray)]
    live = r1.state(host=False)
    held_live = [x.clone() for x in tree_leaves(live) if torch.is_tensor(x)]

    r2 = Runner(_exe(), ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    r2.restore(ckpt)
    a = r1.step(chunks[2])
    b = r2.step(chunks[2])
    c = r2.step(chunks[3])
    _same(a, ref.step(rchunks[2]))
    _same(b, a)
    _same(c, ref.step(rchunks[3]))
    now = [x for x in tree_leaves(ckpt) if isinstance(x, np.ndarray)]
    assert all(np.array_equal(x, y) for x, y in zip(now, held))
    now_live = [x for x in tree_leaves(live) if torch.is_tensor(x)]
    assert all(torch.equal(x, y) for x, y in zip(now_live, held_live))
