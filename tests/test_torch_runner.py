"""The port's chunked runner (``repro_torch.engine``) against the
reference's, as ``tests/test_policy.py``, ``tests/test_engine.py`` and
``tests/test_runner_hotpath.py`` hold the reference at its local points.

* At each of the 4 ``body × keys`` points (``placement="local"``,
  ``dag="solo"``) the port's ``Runner`` is bit-identical to the
  reference's on integer-valued data, chunk for chunk.
* sparse ≡ dense bit for bit (the reference's exactness contract), keyed ≡
  per-key ``partition_run`` at the same partitioning, checkpoint/restore
  bit identity and every ``restore`` rejection, the deprecated wrappers ≡
  ``Runner``, one step built per geometry key, the telemetry, and the
  out-of-scope axes raising.

Every comparison is exact.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import compile as rqc
from repro.core.frontend import TStream as RTStream
from repro.core.stream import SnapshotGrid as RGrid
from repro.engine import ExecPolicy as RPolicy, Runner as RRunner
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.core.parallel import (SparseStreamRunner, StreamRunner,
                                       partition_run)
from repro_torch.data import apps
from repro_torch.engine import (ExecPolicy, KeyedEngine, Runner, keyed_grid,
                                wrap_keyed_step)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

N, K, SEG, SPC = 256, 4, 16, 2


def pw_const(shape, rate, seed):
    rng = np.random.default_rng(seed)
    change = rng.random(shape) < rate
    change[..., 0] = True
    raw = np.floor(rng.random(shape) * 100).astype(np.float32)
    idx = np.maximum.accumulate(
        np.where(change, np.arange(shape[-1]), -1), axis=-1)
    return np.take_along_axis(raw, idx, axis=-1)


def _trend(s):
    return (s.window(16).mean()
            .join(s.window(32).mean(), lambda a, b: a - b)
            .where(lambda d: d > 0))


def _grid(vals, t0=0, valid=None):
    valid = np.ones(vals.shape, bool) if valid is None else valid
    return {"in": keyed_grid(vals, valid, t0=t0, device="cpu")}


def _assert_same(ref, got, ctx=""):
    m1, m2 = np.asarray(ref.valid), np.asarray(got.valid)
    assert np.array_equal(m1, m2), (ctx, m1.sum(), m2.sum())
    assert np.array_equal(np.asarray(ref.value)[m1],
                          np.asarray(got.value)[m1]), ctx


def _exe(keyed=False, sparse=False, out_len=SEG, q=_trend):
    return qc.compile_query(q(TStream.source("in", keyed=keyed)).node,
                            out_len=out_len, sparse=sparse)


def _chunks(vals, span):
    return [(vals[..., c * span:(c + 1) * span], c * span)
            for c in range(vals.shape[-1] // span)]


# ---------------------------------------------------------------------------
# the 4 local×solo points against the reference runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body", ["dense", "sparse"])
@pytest.mark.parametrize("keys", ["single", "vmapped"])
def test_runner_bit_identical_to_reference_runner(body, keys):
    keyed, sparse = keys == "vmapped", body == "sparse"
    vals = pw_const((K, N) if keyed else (N,), 0.04, 11)
    valid = np.random.default_rng(2).random(vals.shape) > 0.05
    exe = _exe(keyed, sparse)
    rexe = rqc.compile_query(_trend(RTStream.source("in", keyed=keyed)).node,
                             out_len=SEG, pallas=False, sparse=sparse)
    r = Runner(exe, ExecPolicy(body=body, keys=keys),
               n_keys=K if keyed else None, segs_per_chunk=SPC)
    rr = RRunner(rexe, RPolicy(body=body, keys=keys),
                 n_keys=K if keyed else None, segs_per_chunk=SPC)
    for (v, t0), (m, _) in zip(_chunks(vals, SEG * SPC),
                               _chunks(valid, SEG * SPC)):
        got = r.step(_grid(v, t0, m))
        want = rr.step({"in": RGrid(value=jnp.asarray(v),
                                    valid=jnp.asarray(m), t0=t0, prec=1)})
        assert got.t0 == want.t0 and got.prec == want.prec
        assert got.valid.shape == tuple(want.valid.shape)
        _assert_same(want, got, (body, keys, t0))
    if sparse:
        assert r.dirty_stats() == rr.dirty_stats()


# ---------------------------------------------------------------------------
# sparse ≡ dense, keyed ≡ per-key partition_run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys", ["single", "vmapped"])
def test_sparse_matches_dense_chunked(keys):
    """Including an all-clean chunk and a change in the last tick of a
    chunk (the carried dirty tail must dirty the next chunk)."""
    keyed = keys == "vmapped"
    span = SEG * 4
    vals = np.full((K, 4 * span) if keyed else (4 * span,), 3.0, np.float32)
    vals[..., span - 1:] = 8.0
    vals[..., 2 * span + 44:] = 2.0
    if keyed:
        vals[1] = pw_const((4 * span,), 0.1, 3)    # one busy key
    dense = Runner(_exe(keyed), ExecPolicy(keys=keys),
                   n_keys=K if keyed else None, segs_per_chunk=4)
    sparse = Runner(_exe(keyed, True), ExecPolicy(body="sparse", keys=keys),
                    n_keys=K if keyed else None, segs_per_chunk=4)
    for v, t0 in _chunks(vals, span):
        _assert_same(dense.step(_grid(v, t0)), sparse.step(_grid(v, t0)),
                     (keys, t0))
    st = sparse.dirty_stats()
    assert st["dirty_units"] < st["units"], st


def test_keyed_runner_compacts_to_small_buckets():
    n_keys, T = 32, 256
    vals = np.zeros((n_keys, T), np.float32)
    for k in range(0, n_keys, 4):                    # 1 in 4 keys active
        vals[k] = pw_const((T,), 0.03, k)
    g = _grid(vals)
    exe_s = _exe(True, True, out_len=64)
    ref = Runner(_exe(True, out_len=64), ExecPolicy(keys="vmapped"),
                 n_keys=n_keys).run(g, 4)
    got = Runner(exe_s, ExecPolicy(body="sparse", keys="vmapped"),
                 n_keys=n_keys).run(g, 4)
    _assert_same(ref, got, "keyed")
    caps = sorted(k[-1] for k in exe_s._runner_step_cache
                  if k[0] == "compute")
    assert caps and caps[0] <= n_keys // 2, caps


@pytest.mark.parametrize("name", apps.KEYED_APPS)
def test_keyed_runner_matches_per_key_partition_run(name):
    params = {"trend": {}, "fraud": {"win": 60}, "ysb": {"win": 8}}[name]
    app = apps.make_keyed_app(name, **params)
    n_keys, T, n_parts = 8, 256, 4
    grids = apps.make_grids(app.make_keyed_input(n_keys, T, 7),
                            device="cpu")
    out_len = (T // n_parts) // app.query.prec
    exe = qc.compile_query(app.query.node, out_len=out_len)
    out = Runner(exe, ExecPolicy(keys="vmapped"), n_keys=n_keys).run(
        grids, n_parts)
    assert out.valid.shape == (n_keys, out_len * n_parts)
    for k in range(0, n_keys, 3):
        one = {nm: g.replace(value=({kk: vv[k] for kk, vv in g.value.items()}
                                    if isinstance(g.value, dict)
                                    else g.value[k]),
                             valid=g.valid[k]) for nm, g in grids.items()}
        ref = partition_run(exe, one, 0, n_parts)
        got = (out.value[k] if not isinstance(out.value, dict)
               else {kk: vv[k] for kk, vv in out.value.items()})
        assert torch.equal(ref.valid, out.valid[k]), (name, k)
        m = ref.valid
        if isinstance(got, dict):
            for kk in got:
                assert torch.equal(ref.value[kk][m], got[kk][m]), (name, k)
        else:
            assert torch.equal(ref.value[m], got[m]), (name, k)


# ---------------------------------------------------------------------------
# checkpoint / restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body", ["dense", "sparse"])
@pytest.mark.parametrize("keys", ["single", "vmapped"])
def test_checkpoint_restore_bit_identical(body, keys):
    keyed = keys == "vmapped"
    vals = pw_const((K, 4 * SEG * SPC) if keyed else (4 * SEG * SPC,),
                    0.05, 13)
    mk = lambda: Runner(_exe(keyed, body == "sparse"),  # noqa: E731
                        ExecPolicy(body=body, keys=keys),
                        n_keys=K if keyed else None, segs_per_chunk=SPC)
    chunks = _chunks(vals, SEG * SPC)
    r1 = mk()
    for v, t0 in chunks[:2]:
        r1.step(_grid(v, t0))
    ckpt = r1.state()
    r2 = mk()
    r2.restore(ckpt)
    for v, t0 in chunks[2:]:
        a, b = r1.step(_grid(v, t0)), r2.step(_grid(v, t0))
        assert a.t0 == b.t0 == t0
        assert torch.equal(a.valid, b.valid) and torch.equal(a.value,
                                                             b.value)


def test_state_and_restore_copy():
    """state() hands out copies a later step cannot reach, and restore()
    copies the caller's arrays in."""
    vals = pw_const((4 * SEG * SPC,), 0.05, 17)
    chunks = _chunks(vals, SEG * SPC)
    mk = lambda: Runner(_exe(sparse=True),  # noqa: E731
                        ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    r1, r2 = mk(), mk()
    r1.step(_grid(*chunks[0]))
    ckpt = r1.state()
    r2.restore(ckpt)
    ckpt["in"][0][...] = 0                # the caller scribbles on its copy
    ckpt["in"][1][...] = False
    ckpt["__sparse"]["dirty"]["in"][...] = True
    a, b = r1.step(_grid(*chunks[1])), r2.step(_grid(*chunks[1]))
    assert torch.equal(a.valid, b.valid) and torch.equal(a.value, b.value)
    fresh = r1.state()
    fresh["in"][0][...] = 7               # ... and on a fresh checkpoint
    fresh["__sparse"]["dirty"]["in"][...] = True
    for v, t0 in chunks[2:]:
        c, d = r1.step(_grid(v, t0)), r2.step(_grid(v, t0))
        assert torch.equal(c.valid, d.valid) and torch.equal(c.value, d.value)


def _ckpt_runner(n_keys=8, sparse=False, window=16):
    exe = qc.compile_query(
        TStream.source("a", keyed=True).window(window).mean().node,
        out_len=32, sparse=sparse)
    r = Runner(exe, ExecPolicy(body="sparse" if sparse else "dense",
                               keys="vmapped"), n_keys=n_keys)
    r.step({"a": keyed_grid(np.ones((n_keys, 32), np.float32),
                            np.ones((n_keys, 32), bool), device="cpu")})
    return exe, r


def test_restore_rejections():
    exe, r = _ckpt_runner()
    state = r.state()
    with pytest.raises(ValueError, match=r"tail shape.*n_keys"):
        Runner(exe, ExecPolicy(keys="vmapped"), n_keys=4).restore(state)
    bad = dict(state)
    bad["bogus"] = bad.pop("a")
    with pytest.raises(ValueError, match=r"unknown=\['bogus'\]"):
        Runner(exe, ExecPolicy(keys="vmapped"), n_keys=8).restore(bad)
    exe64, _ = _ckpt_runner(window=64)
    with pytest.raises(ValueError, match="left_halo"):
        Runner(exe64, ExecPolicy(keys="vmapped"), n_keys=8).restore(state)
    for t in (17, -32, 16.0):
        with pytest.raises(ValueError, match="stream clock"):
            Runner(exe, ExecPolicy(keys="vmapped"), n_keys=8).restore(
                dict(state, __t=t))
    with pytest.raises(ValueError, match="no '__t'"):
        Runner(exe, ExecPolicy(keys="vmapped"), n_keys=8).restore(
            {"a": state["a"]})
    bad = dict(state, a=(state["a"][0][:, :, None], state["a"][1]))
    with pytest.raises(ValueError, match="value leaf shape"):
        Runner(exe, ExecPolicy(keys="vmapped"), n_keys=8).restore(bad)
    exe_s, rs = _ckpt_runner(sparse=True)
    with pytest.raises(ValueError, match="dense engine cannot restore"):
        Runner(exe, ExecPolicy(keys="vmapped"), n_keys=8).restore(
            rs.state())
    with pytest.raises(ValueError, match="sparse engine cannot restore"):
        Runner(exe_s, ExecPolicy(body="sparse", keys="vmapped"),
               n_keys=8).restore(state)
    bad = rs.state()
    bad["__sparse"]["dirty"]["a"] = bad["__sparse"]["dirty"]["a"][:, :3]
    with pytest.raises(ValueError, match="dirty-tail"):
        Runner(exe_s, ExecPolicy(body="sparse", keys="vmapped"),
               n_keys=8).restore(bad)
    # single-key tails are validated too
    exe1 = _exe(out_len=32)
    r1 = Runner(exe1, ExecPolicy())
    r1.step(_grid(pw_const((32,), 0.1, 1)))
    bad = dict(r1.state(), **{"in": (np.zeros(7, np.float32),
                                     np.zeros(7, bool))})
    with pytest.raises(ValueError, match="left_halo"):
        Runner(exe1, ExecPolicy()).restore(bad)


def test_restore_halo_free_prev_snapshot_rules():
    """A halo-free input carries its change lineage in the 1-tick 'prev'
    snapshot: strict restore requires it, non-strict φ-initialises it."""
    a, b = TStream.source("a"), TStream.source("b")
    exe = qc.compile_query(a.window(16).mean().join(b, lambda m, x: x - m)
                           .node, out_len=SEG, sparse=True)
    r = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    v = pw_const((SEG * SPC,), 0.2, 3)
    chunk = {n: keyed_grid(v, np.ones(v.shape, bool), device="cpu")
             for n in ("a", "b")}
    r.step(chunk)
    assert sorted(r._sparse["prev"]) == ["b"]
    st = r.state()
    del st["__sparse"]["prev"]["b"]
    with pytest.raises(ValueError, match="'prev' snapshot"):
        Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC).restore(st)
    r2 = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    r2.restore(st, strict=False)
    assert r2._sparse["prev"]["b"][1].shape == (1, 1)


def test_restores_pre_policy_tuple_seed_checkpoint():
    vals = pw_const((K, 64), 0.05, 10)
    exe = _exe(True, True, out_len=32)
    e1 = KeyedEngine(exe, n_keys=K, sparse=True)
    e1.step(_grid(vals[:, :32]))
    state = e1.state()
    old = dict(state)
    old["__sparse"] = dict(state["__sparse"],
                           seed=state["__sparse"]["seed"]["__out"])
    e2 = KeyedEngine(exe, n_keys=K, sparse=True)
    e2.restore(old)
    a, b = e1.step(_grid(vals[:, 32:], 32)), e2.step(_grid(vals[:, 32:], 32))
    assert torch.equal(a.valid, b.valid) and torch.equal(a.value, b.value)


# ---------------------------------------------------------------------------
# the deprecated wrappers
# ---------------------------------------------------------------------------

def test_wrappers_bit_identical_to_runner():
    vals = pw_const((N,), 0.05, 1)
    exe, exe_s = _exe(out_len=32), _exe(sparse=True, out_len=32)
    with pytest.warns(DeprecationWarning):
        old = StreamRunner(exe)
    new = Runner(exe, ExecPolicy())
    for v, t0 in _chunks(vals, 32):
        _assert_same(new.step(_grid(v, t0)), old.step(_grid(v, t0)), t0)
    with pytest.warns(DeprecationWarning):
        old = SparseStreamRunner(exe_s, segs_per_chunk=4)
    new = Runner(exe_s, ExecPolicy(body="sparse"), segs_per_chunk=4)
    for v, t0 in _chunks(vals, 128):
        _assert_same(new.step(_grid(v, t0)), old.step(_grid(v, t0)), t0)
    st = old.state()
    assert sorted(st) == ["__t", "dirty", "prev", "seed", "tails"]
    again = SparseStreamRunner(exe_s, segs_per_chunk=4)
    again.restore(st)
    assert again._runner.state()["__t"] == st["__t"]
    with pytest.raises(ValueError, match="sparse=True"):
        SparseStreamRunner(exe)
    kv = pw_const((K, N), 0.05, 3)
    exe_k = _exe(True, out_len=64)
    with pytest.warns(DeprecationWarning):
        eng = KeyedEngine(exe_k, n_keys=K)
    _assert_same(Runner(exe_k, ExecPolicy(keys="vmapped"), n_keys=K).run(
        _grid(kv), N // 64), eng.run(_grid(kv), N // 64), "keyed")


# ---------------------------------------------------------------------------
# policy, validation, out-of-scope axes
# ---------------------------------------------------------------------------

def test_policy_values_describe_and_out_of_scope_axes():
    with pytest.raises(ValueError, match="body"):
        ExecPolicy(body="chunky")
    with pytest.raises(ValueError, match="keys"):
        ExecPolicy(keys="many")
    with pytest.raises(ValueError, match="dag"):
        ExecPolicy(dag="forest")
    with pytest.raises(ValueError, match="placement"):
        ExecPolicy(placement="cloud")
    with pytest.raises(NotImplementedError, match="A14"):
        ExecPolicy(placement="mesh")
    p = ExecPolicy(body="sparse", keys="vmapped")
    assert p.sparse and p.keyed and not p.union
    assert ExecPolicy(dag="union").union       # ported: ROADMAP A11
    for body in ("dense", "sparse"):
        for keys in ("single", "vmapped"):
            for dag in ("solo", "union"):
                assert (ExecPolicy(body=body, keys=keys, dag=dag).describe()
                        == RPolicy(body=body, keys=keys,
                                   dag=dag).describe())
    r = Runner(_exe(), ExecPolicy())
    # late-data revision is ported (ROADMAP A12): enabling it raises only
    # on a bad horizon, and revise() only before it is enabled
    with pytest.raises(ValueError, match="revision disabled"):
        r.revise(0, [], [])
    r.enable_revision(2)
    assert r.revision_horizon == 2
    for call, item in ((r.staged_steps, "A13"), (r.chunk_fn, "A13"),
                       (r.aot_keys, "A13"), (r.audit_example_chunks, "A15")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(NotImplementedError, match="A14"):
        KeyedEngine(_exe(True), n_keys=4, mesh=object())
    with pytest.raises(NotImplementedError, match="A14"):
        wrap_keyed_step(lambda t, c: (t, c), mesh=object())
    step = lambda t, c: (t, c)  # noqa: E731
    assert wrap_keyed_step(step) is step


def test_runner_validation():
    with pytest.raises(ValueError, match="n_keys"):
        Runner(_exe(True), ExecPolicy(keys="vmapped"))
    with pytest.raises(ValueError, match="keys='single'"):
        Runner(_exe(), ExecPolicy(), n_keys=4)
    with pytest.raises(ValueError, match="sparse=True"):
        Runner(_exe(), ExecPolicy(body="sparse"))
    with pytest.raises(ValueError, match="segs_per_chunk"):
        Runner(_exe(), ExecPolicy(), segs_per_chunk=0)
    with pytest.raises(NotImplementedError, match="lookahead"):
        Runner(qc.compile_query(TStream.source("in").shift(-4).node,
                                out_len=16), ExecPolicy())
    a, b = TStream.source("a", keyed=True), TStream.source("b")
    with pytest.raises(ValueError, match="keyed"):
        Runner(qc.compile_query(a.join(b, lambda x, y: x + y).node,
                                out_len=32),
               ExecPolicy(keys="vmapped"), n_keys=8)
    r = Runner(_exe(True), ExecPolicy(keys="vmapped"), n_keys=4)
    with pytest.raises(ValueError, match="chunk validity shape"):
        r.step(_grid(np.zeros((4, 15), np.float32)))
    assert r.state() == {"__t": 0}          # a raise leaves no state


# ---------------------------------------------------------------------------
# step cache and telemetry
# ---------------------------------------------------------------------------

def test_exactly_one_build_per_geometry_key():
    exe = _exe(sparse=True)
    r = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    vals = pw_const((6 * SEG * SPC,), 0.03, 21)
    for v, t0 in _chunks(vals, SEG * SPC):
        r.step(_grid(v, t0))
    counts = r.metrics.snapshot()["compiles"]["counts"]
    assert counts["sparse_fused(K=1,segs=2,True)"] == 1
    assert counts["sparse_fused(K=1,segs=2,False)"] == 1
    assert counts["obs_accum(K=1,segs=2)"] == 1
    assert any(k.startswith("compute(K=1,segs=2,") for k in counts)
    assert all(n == 1 for n in counts.values()), counts
    # a second runner over the same executable reuses every built step
    r2 = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    for v, t0 in _chunks(vals, SEG * SPC):
        r2.step(_grid(v, t0))
    assert r2.metrics.snapshot()["compiles"]["counts"] == {}


def test_runner_metrics_snapshot():
    r = Runner(_exe(sparse=True), ExecPolicy(body="sparse"),
               segs_per_chunk=4)
    vals = pw_const((3 * SEG * 4,), 0.03, 3)
    for v, t0 in _chunks(vals, SEG * 4):
        r.step(_grid(v, t0))
    stats = r.dirty_stats()
    assert stats["chunks"] == 3 and stats["units"] == 12
    snap = r.metrics.snapshot()
    assert robs.validate_snapshot(snap) == []
    assert snap["counters"]["runner.chunks"]["value"] == 3
    assert snap["counters"]["runner.units"]["value"] == 12
    assert (snap["counters"]["runner.dirty_units"]["value"]
            == stats["dirty_units"])
    assert snap["gauges"]["runner.compact"]["value"] == stats["compact"]
    assert snap["histograms"]["runner.step_seconds"]["count"] == 3
    assert snap["histograms"]["runner.dirty_fraction"]["count"] == 3
    assert snap["vectors"]["runner.bucket_picks"]["labels"] == ["1", "2",
                                                                "4"]
    assert sum(snap["vectors"]["runner.bucket_picks"]["values"]) == 3
    r.metrics.reset_after_warmup()
    snap = r.metrics.snapshot()
    assert snap["counters"]["runner.chunks"]["value"] == 0
    assert sum(snap["vectors"]["runner.bucket_picks"]["values"]) == 0
    r.step(_grid(pw_const((SEG * 4,), 0.03, 5), 3 * SEG * 4))
    assert r.dirty_stats()["chunks"] == 1
    assert sum(r.metrics.snapshot()["vectors"]["runner.bucket_picks"]
               ["values"]) == 1
    r.reset()
    assert r.dirty_stats() is None and r.state()["__t"] == 0
    # folded into the registry's host base, not lost
    assert r.metrics.snapshot()["counters"]["runner.dirty_units"][
        "value"] >= 1


def test_dense_runner_metrics_have_no_sparse_slots():
    r = Runner(_exe(), ExecPolicy())
    r.step(_grid(pw_const((SEG,), 0.1, 1)))
    snap = r.metrics.snapshot()
    assert "runner.bucket_picks" not in snap["vectors"]
    assert r.dirty_stats() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert robs.validate_snapshot(snap) == []
