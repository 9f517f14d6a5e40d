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
* Mesh placement on a 1-rank gloo mesh, as ``tests/test_policy.py`` holds
  the reference on its 1-device mesh: the accessors, ``KeyedEngine(mesh=,
  sparse=True)``, the sparse single-keyed runner sharding segments, every
  point of ``body × keys × placement × dag`` against the reference's
  runner at the same point, a property over random points and change
  rates, the state's global layout and the cache and manifest keys
  carrying the mesh.  The 8-rank points are in
  ``tests/test_torch_multidev.py``.

Every comparison is exact.
"""
import contextlib
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro import obs as robs
from repro.core import compile as rqc
from repro.core.frontend import TStream as RTStream
from repro.core.stream import SnapshotGrid as RGrid
from repro.engine import ExecPolicy as RPolicy, Runner as RRunner
from repro.engine import KeyedEngine as RKeyedEngine
from repro.engine import keyed_grid as r_keyed_grid
from repro.engine import mesh_placement as r_mesh_placement
from repro.multiquery import union_runner as r_union_runner
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.core.parallel import (SparseStreamRunner, StreamRunner,
                                       partition_run)
from repro_torch.data import apps
from repro_torch.engine import (ExecPolicy, KeyedEngine, MeshPlacement,
                                Runner, keyed_grid, mesh_placement,
                                wrap_keyed_step)
from repro_torch.launch.mesh import group_serial, make_local_mesh
from repro_torch.multiquery import union_runner

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

N, K, SEG, SPC = 256, 4, 16, 2


@pytest.fixture(scope="module")
def mesh1():
    """The port's 1-rank gloo mesh (``("data", "model")``)."""
    return make_local_mesh(n_data=1, device="cpu")


def _rmesh1():
    import jax
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


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
    params = {"trend": {}, "fraud": {"win": 60}, "ysb": {"win": 8},
              "qrs": {}}[name]
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
    # mesh placement is ported (ROADMAP A14): a bare string names no mesh,
    # and is refused as the reference refuses it
    with pytest.raises(ValueError, match="placement"):
        ExecPolicy(placement="mesh")
    with pytest.raises(ValueError, match="placement"):
        RPolicy(placement="mesh")
    p = ExecPolicy(body="sparse", keys="vmapped")
    assert p.sparse and p.keyed and not p.union
    assert ExecPolicy(dag="union").union       # ported: ROADMAP A11
    mesh = make_local_mesh(n_data=1, device="cpu")
    for body in ("dense", "sparse"):
        for keys in ("single", "vmapped"):
            for dag in ("solo", "union"):
                for pl, rpl in (("local", "local"),
                                (mesh_placement(mesh),
                                 r_mesh_placement(_rmesh1()))):
                    assert (ExecPolicy(body=body, keys=keys, dag=dag,
                                       placement=pl).describe()
                            == RPolicy(body=body, keys=keys, dag=dag,
                                       placement=rpl).describe())
    r = Runner(_exe(), ExecPolicy())
    # late-data revision is ported (ROADMAP A12): enabling it raises only
    # on a bad horizon, and revise() only before it is enabled
    with pytest.raises(ValueError, match="revision disabled"):
        r.revise(0, [], [])
    r.enable_revision(2)
    assert r.revision_horizon == 2 and r.revise_bound is None
    # the serving surface is ported (ROADMAP A13), and the audit surface
    # (A15): zero chunks in step's layout, on the runner's device (CUDA
    # unless asked for the CPU), as the reference's
    assert [label for label, _ in r.aot_keys()] == [
        "dense", "revise(1)"]
    ex = r.audit_example_chunks("cpu")
    ref_ex = RRunner(rqc.compile_query(_trend(RTStream.source("in")).node,
                                       out_len=SEG, pallas=False),
                     RPolicy()).audit_example_chunks()
    assert set(ex) == set(ref_ex)
    for name, g in ex.items():
        assert g.valid.device.type == "cpu" and not g.valid.any()
        assert tuple(g.valid.shape) == tuple(ref_ex[name].valid.shape)
    # the mesh forms the reference has (ROADMAP A14): KeyedEngine(mesh=)
    # places its runner on the mesh, wrap_keyed_step(mesh=) shards the key
    # axis and gathers both results back
    eng = KeyedEngine(_exe(True), n_keys=4, mesh=mesh)
    assert eng._runner.policy.placement == MeshPlacement(mesh, "data")
    assert eng._runner.policy.describe() == "dense×vmapped×mesh1×solo"
    step = lambda t, c: (t + 1, c * 2)  # noqa: E731
    assert wrap_keyed_step(step) is step
    tails, chunks = torch.arange(8.).reshape(4, 2), torch.ones(4, 3)
    out, new = wrap_keyed_step(step, mesh=mesh)(tails, chunks)
    assert torch.equal(out, tails + 1) and torch.equal(new, chunks * 2)


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


PARTS = ["ingest", "load", "launch", "copy_out", "grids"]


@pytest.mark.parametrize("body", ["dense", "sparse"])
def test_unrecorded_step_reads_no_ns_clock_and_records_no_event(
        body, monkeypatch):
    r = Runner(_exe(sparse=body == "sparse"), ExecPolicy(body=body),
               segs_per_chunk=SPC)
    (v0, t0), (v1, t1) = _chunks(pw_const((2 * SEG * SPC,), 0.05, 4),
                                 SEG * SPC)
    r.step(_grid(v0, t0))
    reads, real = [], time.perf_counter_ns
    monkeypatch.setattr(time, "perf_counter_ns",
                        lambda: reads.append(1) or real())
    r.step(_grid(v1, t1))
    assert reads == [] and r.metrics.tracer.events() == []
    assert r.metrics.snapshot()["histograms"]["runner.step_seconds"][
        "count"] == 2


@pytest.mark.parametrize("body", ["dense", "sparse"])
def test_recorded_step_is_runner_step_and_its_five_parts(body):
    r = Runner(_exe(sparse=body == "sparse"), ExecPolicy(body=body),
               segs_per_chunk=SPC)
    chunks = _chunks(pw_const((3 * SEG * SPC,), 0.05, 6), SEG * SPC)
    r.step(_grid(*chunks[0]))
    r.metrics.reset_after_warmup()
    tr = r.metrics.tracer
    tr.start_recording(64)
    for v, t0 in chunks[1:]:
        r.step(_grid(v, t0))
    tr.stop_recording()
    ev = tr.events()
    assert len(ev) == 12 and tr.dropped == 0
    for c in (0, 6):
        step, parts = ev[c], ev[c + 1:c + 6]
        assert step.path == "runner.step" and step.parent == -1
        assert [e.path for e in parts] == [f"runner.step/{p}"
                                           for p in PARTS]
        assert all(e.parent == c for e in parts)
        assert {e.chunk for e in ev[c:c + 6]} == {step.chunk}
        assert step.start_ns <= parts[0].start_ns
        assert all(a.end_ns == b.start_ns for a, b in zip(parts, parts[1:]))
        assert parts[-1].end_ns <= step.end_ns
    assert ev[0].chunk != ev[6].chunk
    # the latency histogram takes the span's own clock reads
    hist = r.metrics.snapshot()["histograms"]["runner.step_seconds"]
    assert hist["count"] == 2
    assert np.isclose(hist["sum"], sum(e.end_ns - e.start_ns
                                       for e in ev[::6]) / 1e9)
    assert set(tr.self_times()) == {"runner.step"} | {
        f"runner.step/{p}" for p in PARTS}
    assert tr.device_chunks() == []          # no chunk events on the CPU


def test_each_capture_is_one_runner_capture_span(monkeypatch):
    from repro_torch.engine import capture
    r = Runner(_exe(), ExecPolicy(), segs_per_chunk=SPC)
    grid = _grid(pw_const((SEG * SPC,), 0.1, 2))
    assert r.install_executable(("dense",), chunks=grid) == "eager"
    tr = r.metrics.tracer
    assert tr.span_report()["runner.install"]["count"] == 1
    # the card's capture path, with its warm-up and capture faked
    monkeypatch.setattr(capture, "warm_up",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(capture, "record", lambda step, pool, keep=False:
                        capture.Captured(None, step(), []))
    work, dev = r._work, r._work.dev
    for _ in range(2):
        r._graph(work, ("dense",), r._cache_key("dense", dev),
                 r._dense_step(dev))
    rep = tr.span_report()
    assert rep["runner.capture"]["count"] == 1 == sum(
        tr.captures().values())
    assert rep["runner.capture/warm_up"]["count"] == 1
    assert rep["runner.capture/record"]["count"] == 1


# ---------------------------------------------------------------------------
# mesh placement on the 1-rank mesh (tests/test_policy.py's _mesh1 points)
# ---------------------------------------------------------------------------

def _bands(s):
    return s.window(24).max().join(s, lambda h, x: h - x)


def test_policy_mesh_accessors_and_describe(mesh1):
    p = ExecPolicy(body="sparse", keys="vmapped",
                   placement=mesh_placement(mesh1), dag="union")
    assert p.sparse and p.keyed and p.union
    assert p.mesh is mesh1 and p.axis == "data" and p.n_shards == 1
    assert p.rank == 0
    assert p.describe() == "sparse×vmapped×mesh1×union"
    assert ExecPolicy().describe() == "dense×single×local×solo"
    # a bare mesh is accepted and normalized onto its first axis
    assert ExecPolicy(placement=mesh1).axis == "data"
    assert ExecPolicy(placement=mesh1).placement == MeshPlacement(mesh1)
    assert repr(mesh_placement(mesh1)) == "mesh(axis='data', n=1)"


def test_keyed_engine_sparse_mesh_matches_dense_local(mesh1):
    vals = pw_const((K, N), 0.03, seed=4)
    exe_d = _exe(True, out_len=64)
    exe_s = _exe(True, True, out_len=64)
    g = _grid(vals)
    ref = KeyedEngine(exe_d, n_keys=K).run(g, N // 64)
    eng = KeyedEngine(exe_s, n_keys=K, mesh=mesh1, sparse=True)
    _assert_same(ref, eng.run(g, N // 64), "sparse+mesh")


def test_runner_sparse_mesh_single_keys_shards_segments(mesh1):
    """``ExecPolicy(body=sparse, placement=mesh)`` with keys='single':
    segments shard over the mesh, per-shard compaction, bit-identical to
    the dense local runner and to the reference's on its 1-device mesh."""
    vals = pw_const((N,), 0.03, seed=5)
    ref = Runner(_exe(out_len=32), ExecPolicy()).run(_grid(vals), N // 32)
    got = Runner(_exe(sparse=True, out_len=32),
                 ExecPolicy(body="sparse", placement=mesh_placement(mesh1)),
                 segs_per_chunk=4).run(_grid(vals), N // 128)
    _assert_same(ref, got, "sparse×single×mesh")
    rexe = rqc.compile_query(_trend(RTStream.source("in")).node, out_len=32,
                             pallas=False, sparse=True)
    want = RRunner(rexe, RPolicy(body="sparse",
                                 placement=r_mesh_placement(_rmesh1())),
                   segs_per_chunk=4).run(
        {"in": RGrid(value=jnp.asarray(vals),
                     valid=jnp.ones(N, bool), t0=0, prec=1)}, N // 128)
    _assert_same(want, got, "reference")


@pytest.mark.parametrize("body", ["dense", "sparse"])
@pytest.mark.parametrize("keys", ["single", "vmapped"])
@pytest.mark.parametrize("placement", ["local", "mesh"])
@pytest.mark.parametrize("dag", ["solo", "union"])
def test_policy_matrix_against_reference(mesh1, body, keys, placement, dag):
    """Every point of ``body × keys × placement × dag`` equals the
    reference's runner at the same point (its 1-device mesh) bit for bit,
    chunk after chunk, on integer data."""
    keyed, sparse = keys == "vmapped", body == "sparse"
    seg, k = 16, 3
    vals = pw_const((k, 128) if keyed else (128,), 0.05, 21)
    pl = mesh_placement(mesh1) if placement == "mesh" else "local"
    rpl = r_mesh_placement(_rmesh1()) if placement == "mesh" else "local"
    policy = ExecPolicy(body=body, keys=keys, placement=pl, dag=dag)
    rpolicy = RPolicy(body=body, keys=keys, placement=rpl, dag=dag)
    kw = dict(n_keys=k if keyed else None, segs_per_chunk=2)
    s = TStream.source("in", prec=1, keyed=keyed)
    rs = RTStream.source("in", prec=1, keyed=keyed)
    if dag == "solo":
        r = Runner(qc.compile_query(_trend(s).node, out_len=seg,
                                    sparse=sparse), policy, **kw)
        rr = RRunner(rqc.compile_query(_trend(rs).node, out_len=seg,
                                       pallas=False, sparse=sparse),
                     rpolicy, **kw)
    else:
        r = union_runner({"trend": _trend(s), "bands": _bands(s)}, seg,
                         policy, **kw)
        rr = r_union_runner({"trend": _trend(rs), "bands": _bands(rs)}, seg,
                            rpolicy, pallas=False, **kw)
    for v, t0 in _chunks(vals, 2 * seg):
        got = r.step(_grid(v, t0))
        want = rr.step({"in": RGrid(value=jnp.asarray(v),
                                    valid=jnp.ones(v.shape, bool), t0=t0,
                                    prec=1)})
        if dag == "solo":
            got, want = {"trend": got}, {"trend": want}
        for name in got:
            _assert_same(want[name], got[name], (policy.describe(), name,
                                                 t0))


def test_policy_matrix_property_with_mesh(mesh1):
    """Property: random policy points (placement included) × random change
    patterns on a small query zoo never diverge from the reference's dense
    single-stream ``partition_run`` (integer-valued data)."""
    from hypothesis import given, settings, strategies as st
    from repro.core.parallel import partition_run as r_partition_run

    n, seg = 128, 16
    zoo = {"trend": _trend, "bands": _bands,
           "tumbling": lambda s: s.window(8, stride=8).sum()}

    @settings(max_examples=12, deadline=None, database=None)
    @given(st.sampled_from(["dense", "sparse"]),
           st.sampled_from(["single", "vmapped"]), st.booleans(),
           st.sampled_from(sorted(zoo)), st.integers(0, 2 ** 31 - 1),
           st.floats(0.0, 1.0))
    def prop(body, keys, use_mesh, qname, seed, rate):
        keyed = keys == "vmapped"
        vals = pw_const((K, n) if keyed else (n,), rate, seed)
        q = zoo[qname](TStream.source("in", prec=1, keyed=keyed))
        rq = zoo[qname](RTStream.source("in", prec=1))
        out_len = seg // q.node.prec
        r = Runner(qc.compile_query(q.node, out_len=out_len,
                                    sparse=body == "sparse"),
                   ExecPolicy(body=body, keys=keys,
                              placement=(mesh_placement(mesh1) if use_mesh
                                         else "local")),
                   n_keys=K if keyed else None, segs_per_chunk=2)
        got = r.run(_grid(vals), n // (2 * seg))
        rexe = rqc.compile_query(rq.node, out_len=n // q.node.prec,
                                 pallas=False)
        rows = range(0, K, 3) if keyed else [None]
        for i in rows:
            row = vals if i is None else vals[i]
            ref = r_partition_run(rexe, {"in": RGrid(
                value=jnp.asarray(row), valid=jnp.ones(n, bool), t0=0,
                prec=1)}, 0, 1)
            gv, gm = (got.value, got.valid) if i is None else (
                got.value[i], got.valid[i])
            _assert_same(ref, RGrid(value=gv.numpy(), valid=gm.numpy(),
                                    t0=0, prec=q.node.prec),
                         (body, keys, use_mesh, qname, i))

    prop()


@pytest.mark.parametrize("body", ["dense", "sparse"])
@pytest.mark.parametrize("keys", ["single", "vmapped"])
def test_mesh_state_is_the_global_layout(mesh1, body, keys):
    """A mesh runner's ``state()`` is the local runner's, array for array
    (the reference's global layout), and a checkpoint moves between the
    two placements and continues to the same outputs."""
    keyed = keys == "vmapped"
    vals = pw_const((K, N) if keyed else (N,), 0.05, 8)
    exe = _exe(keyed, body == "sparse")
    kw = dict(n_keys=K if keyed else None, segs_per_chunk=SPC)
    span = SEG * SPC
    chunks = _chunks(vals, span)
    local = Runner(exe, ExecPolicy(body=body, keys=keys), **kw)
    mesh = Runner(exe, ExecPolicy(body=body, keys=keys,
                                  placement=mesh_placement(mesh1)), **kw)
    for v, t0 in chunks[:3]:
        local.step(_grid(v, t0))
        mesh.step(_grid(v, t0))
    st_l, st_m = local.state(), mesh.state()
    flat_l, spec_l = tree_flatten(st_l)
    flat_m, spec_m = tree_flatten(st_m)
    assert spec_l == spec_m
    for a, b in zip(flat_l, flat_m):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    a = Runner(exe, ExecPolicy(body=body, keys=keys,
                               placement=mesh_placement(mesh1)), **kw)
    a.restore(st_l)
    b = Runner(exe, ExecPolicy(body=body, keys=keys), **kw)
    b.restore(st_m)
    for v, t0 in chunks[3:]:
        want = local.step(_grid(v, t0))
        _assert_same(want, a.step(_grid(v, t0)), "local state in mesh")
        _assert_same(want, b.step(_grid(v, t0)), "mesh state in local")


def test_mesh_runner_keys_carry_the_mesh(mesh1, monkeypatch):
    """The built steps' cache keys and the capture manifests' fingerprints
    carry the mesh reduced to its shape and axis: a mesh runner and a
    local one over one query never share a step, and a manifest written at
    one shard count reads as a miss at another."""
    from repro_torch.engine import policy as pol
    from repro_torch.serve import step_fingerprint
    exe = _exe(sparse=True)
    local = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    mesh = Runner(exe, ExecPolicy(body="sparse",
                                  placement=mesh_placement(mesh1)),
                  segs_per_chunk=SPC)
    assert Runner._KEY_DOFS == ("K", "n_segs", "device", "mesh", "axis")
    dofs = mesh.staging_key_dofs("cpu")
    at = ((1, 1), 0, group_serial(mesh1.get_group("data")))
    assert dofs["mesh"] == at and dofs["axis"] == "data"
    assert local.staging_key_dofs("cpu")["mesh"] is None
    vals = pw_const((N,), 0.05, 3)
    for r in (local, mesh):
        r.step(_grid(vals[:SEG * SPC]))
    labels = set(exe._runner_step_cache)
    assert any(k[4] is None for k in labels)
    assert any(k[4] == at for k in labels)
    assert any("mesh=data" in lab for lab in mesh.metrics.tracer.compiles())
    assert mesh.capacity_ladder() == local.capacity_ladder()
    fp1 = step_fingerprint(mesh, "dense")
    assert fp1 != step_fingerprint(local, "dense")
    monkeypatch.setattr(pol.ExecPolicy, "n_shards",
                        property(lambda self: 2))
    assert step_fingerprint(mesh, "dense") != fp1


@pytest.mark.parametrize("body", ["dense", "sparse"])
@pytest.mark.parametrize("keys", ["single", "vmapped"])
def test_same_shape_meshes_over_two_groups_share_no_step(mesh1, body, keys,
                                                         monkeypatch):
    """Two meshes of one shape over different process groups: runners of
    one query on each build their own steps (the step cache keys carry the
    axis group), and each runner's steps gather through its own group —
    a step reused across the two would gather through the other one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch import mesh as lm
    groups = [dist.new_group([0]) for _ in range(2)]
    meshes = [DeviceMesh.from_group(g, "cpu", mesh_dim_names=("data",))
              for g in groups]
    keyed = keys == "vmapped"
    exe = _exe(keyed=keyed, sparse=body == "sparse")
    kw = dict(n_keys=K if keyed else None, segs_per_chunk=SPC)
    local = Runner(exe, ExecPolicy(body=body, keys=keys), **kw)
    runners = [Runner(exe, ExecPolicy(body=body, keys=keys,
                                      placement=mesh_placement(m)), **kw)
               for m in meshes]
    seen = []
    gather = lm.dist.all_gather_into_tensor

    def spy(out, x, group=None):
        seen.append(group)
        return gather(out, x, group=group)

    monkeypatch.setattr(lm.dist, "all_gather_into_tensor", spy)
    vals = pw_const((K, N) if keyed else (N,), 0.05, 5)
    for v, t0 in _chunks(vals, SEG * SPC):
        want = local.step(_grid(v, t0))
        for g, r in zip(groups, runners):
            seen.clear()
            _assert_same(want, r.step(_grid(v, t0)), (body, keys, t0))
            assert seen and all(x is g for x in seen), (body, keys, t0)
    keys_of = [{r._cache_key("dense", "cpu")} for r in runners]
    assert keys_of[0] != keys_of[1]
