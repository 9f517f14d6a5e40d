"""The port's multi-query sharing (``repro_torch.multiquery``) as
``tests/test_multiquery.py`` holds the reference, and against the
reference.

The contract: a ``MultiQuerySession`` serving N queries from one pass is
bit-identical to running each query independently through the solo
runner, across chunk boundaries; sharing is real (shared interior nodes
evaluate once per chunk); attach/detach mid-run preserves the merged halo
state exactly.  Against the reference: the port's session equals the
reference's (``pallas=False``) on the same data, unkeyed and keyed, dense
and sparse, through attach and detach; ``plan_union`` plans the same
contracts; a reference session's ``state()`` carried in through
``convert.state_from_numpy`` continues to the same outputs.  On a 1-rank
gloo mesh (the reference's 1-device mesh): ``shard_union_run`` against
the session and the reference's, the halo-hop report, and the keyed
session with ``mesh=`` against the reference's through attach and detach.

Test data is integer-valued (floor of uniforms): f32 window sums over
small integers are exact, so every comparison within the port is bit for
bit, and so is every dashboard head that reads only means against the
reference.  The breakout and momentum heads read the stddev's E[x^2] -
E[x]^2, which XLA contracts into a fused multiply-add and the port does
not, so against the reference the data are integers in [0, 16): an ulp
or two of E[x^2] <= 256 moves a 40-tick stddev of such noise (about 4.6)
by ~1e-5, and the heads agree within ``STD_TOL``; a breakout may flip only
where its operand lies within ``STD_TOL`` of 0.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ir as rir, plan as rplan
from repro.core.frontend import TStream as RTStream
from repro.core.stream import SnapshotGrid as RGrid
from repro.data import apps as RA
from repro.core.parallel import check_single_hop_halo as r_check_hops
from repro.launch.mesh import make_local_mesh as r_make_local_mesh
from repro.multiquery import MultiQuerySession as RSession
from repro.multiquery import shard_union_run as r_shard_union_run
from repro_torch import convert
from repro_torch.core import compile as qc, ir, plan as qplan
from repro_torch.core.frontend import TStream
from repro_torch.core.stream import SnapshotGrid
from repro_torch.data import apps as A
from repro_torch.core.parallel import check_single_hop_halo
from repro_torch.engine import ExecPolicy, Runner, keyed_grid
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.multiquery import (MultiQuerySession, SharedPlanCache,
                                    shard_union_run, union_runner)
from torch_plan_common import assert_node_grids

SPAN, N_CHUNKS = 64, 3     # 3 chunks => 2 chunk boundaries
K = 8
N_DASH = 16
STD_TOL = 1e-4


def _int_stream(shape, seed, p_valid=1.0, top=100):
    rng = np.random.default_rng(seed)
    vals = np.floor(rng.random(shape) * top).astype(np.float32)
    valid = (rng.random(shape) < p_valid) if p_valid < 1.0 \
        else np.ones(shape, bool)
    return vals, valid


def _pw_stream(shape, seed, rate=0.05):
    """Piecewise-constant integers: most segments see no change, so a
    sparse session really skips."""
    rng = np.random.default_rng(seed)
    shape = tuple(np.atleast_1d(shape))
    change = rng.random(shape) < rate
    change[..., 0] = True
    raw = np.floor(rng.random(shape) * 100).astype(np.float32)
    idx = np.maximum.accumulate(
        np.where(change, np.arange(shape[-1]), -1), axis=-1)
    return np.take_along_axis(raw, idx, axis=-1), np.ones(shape, bool)


def _dash(keyed=False, n=N_DASH, pkg=A):
    # window sizes < SPAN so halo carry across chunks is exercised
    return pkg.dashboard_queries(n, short=12, long=40, keyed=keyed)


def _grid(vals, valid):
    return keyed_grid(vals, valid, device="cpu")


def _assert_bit_identical(got: SnapshotGrid, want, ctx):
    wm = want.valid if torch.is_tensor(want.valid) else torch.from_numpy(
        np.array(want.valid))
    wv = want.value if torch.is_tensor(want.value) else torch.from_numpy(
        np.array(want.value))
    assert torch.equal(got.valid, wm), ctx
    assert torch.equal(got.value[got.valid], wv[wm]), ctx


def _assert_head(got: SnapshotGrid, want, name, ctx):
    """A dashboard head of the port against the reference's (see the module
    docstring): the mean-only heads bit for bit, the stddev heads within
    ``STD_TOL``."""
    if int(name[1:]) % 4 < 2:
        _assert_bit_identical(got, want, ctx)
        return
    wm = torch.from_numpy(np.array(want.valid))
    wv = torch.from_numpy(np.array(want.value))
    both = got.valid & wm
    assert ((got.value[both] - wv[both]).abs() <= STD_TOL).all(), ctx
    assert (wv[got.valid != wm].abs() <= STD_TOL).all(), ctx


def _solo(q, keyed):
    return Runner(qc.compile_query(q.node, out_len=SPAN),
                  ExecPolicy(keys="vmapped" if keyed else "single"),
                  n_keys=K if keyed else None)


# ---------------------------------------------------------------------------
# equivalence: shared == independent, unkeyed and keyed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
def test_session_matches_independent_runner_unkeyed(sparse):
    queries = _dash(n=6)
    vals, valid = _int_stream(SPAN * N_CHUNKS, seed=3, p_valid=0.9)
    full = {"in": _grid(vals, valid)}
    sess = MultiQuerySession(SPAN, sparse=sparse)
    for name, q in queries.items():
        sess.attach(name, q)
    outs = sess.run(full, N_CHUNKS)
    for name, q in queries.items():
        _assert_bit_identical(outs[name], _solo(q, False).run(full, N_CHUNKS),
                              name)


@pytest.mark.parametrize("sparse", [False, True])
def test_prepared_session_matches_the_reference_session(sparse):
    """A session whose union steps were prepared ahead (``prepare``, what
    a served session does before its first chunk) computes the reference
    session's bits: the mean-only heads exactly, the stddev heads within
    ``STD_TOL``."""
    vals, valid = _int_stream((K, SPAN * N_CHUNKS), seed=4, top=16)
    sess = MultiQuerySession(SPAN, n_keys=K, sparse=sparse)
    ref = RSession(SPAN, pallas=False, n_keys=K, sparse=sparse)
    for (name, q), (_n, rq) in zip(_dash(True).items(),
                                   _dash(True, pkg=RA).items()):
        sess.attach(name, q)
        ref.attach(name, rq)
    assert sess.runner is None
    first = {"in": _grid(vals[:, :SPAN], valid[:, :SPAN])}
    report = sess.prepare(first)
    assert report and set(report.values()) == {"eager"}
    labels = {"sparse_fused(first)", "sparse_fused(steady)"} if sparse \
        else {"dense"}
    assert set(report) == labels
    got = sess.run({"in": _grid(vals, valid)}, N_CHUNKS)
    want = ref.run({"in": _rgrid(vals, valid)}, N_CHUNKS)
    for name in got:
        _assert_head(got[name], want[name], name, f"{name} sparse={sparse}")


@pytest.mark.parametrize("sparse", [False, True])
def test_session_matches_independent_keyed_runner(sparse):
    queries = _dash(keyed=True, n=6)
    vals, valid = _int_stream((K, SPAN * N_CHUNKS), seed=4, p_valid=0.85)
    grids = {"in": _grid(vals, valid)}
    sess = MultiQuerySession(SPAN, n_keys=K, sparse=sparse)
    for name, q in queries.items():
        sess.attach(name, q)
    outs = sess.run(grids, N_CHUNKS)
    for name, q in queries.items():
        _assert_bit_identical(outs[name], _solo(q, True).run(grids, N_CHUNKS),
                              name)


@pytest.mark.parametrize("keyed,sparse", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_soe_session_matches_block_session(keyed, sparse):
    """``sum_algo="soe"`` takes the windowed sums through ``prefix_scan``
    (``P[t] - P[t-W]``); on integer data both it and the block sum are
    exact, so the two sessions are bit for bit, and so is the soe session
    against solo runners compiled with ``sum_algo="soe"``."""
    queries = _dash(keyed=keyed, n=8)
    shape = (K, SPAN * N_CHUNKS) if keyed else SPAN * N_CHUNKS
    vals, valid = _int_stream(shape, seed=13, p_valid=0.9)
    grids = {"in": _grid(vals, valid)}
    outs = {}
    for algo in ("block", "soe"):
        sess = MultiQuerySession(SPAN, n_keys=K if keyed else None,
                                 sparse=sparse, sum_algo=algo)
        for name, q in queries.items():
            sess.attach(name, q)
        outs[algo] = sess.run(grids, N_CHUNKS)
    for name, q in queries.items():
        _assert_bit_identical(outs["soe"][name], outs["block"][name], name)
        solo = Runner(qc.compile_query(q.node, out_len=SPAN, sum_algo="soe"),
                      ExecPolicy(keys="vmapped" if keyed else "single"),
                      n_keys=K if keyed else None)
        _assert_bit_identical(outs["soe"][name], solo.run(grids, N_CHUNKS),
                              name)


def test_session_equivalence_with_mixed_windows():
    """Queries with *different* lookbacks share a source whose union grid is
    wider than any single query's plan; outputs must still match the
    per-query baselines exactly."""
    def variant(w, thr):
        s = TStream.source("in", prec=1)
        return (s.window(w).mean().join(s, lambda m, x: x - m)
                .where(lambda d, t=thr: d > t))

    queries = {"w16": variant(16, 0.0), "w48": variant(48, 1.0),
               "w24": variant(24, 2.0)}
    vals, valid = _int_stream(SPAN * N_CHUNKS, seed=9, p_valid=0.9)
    full = {"in": _grid(vals, valid)}
    sess = MultiQuerySession(SPAN)
    for name, q in queries.items():
        sess.attach(name, q)
    outs = sess.run(full, N_CHUNKS)
    for name, q in queries.items():
        _assert_bit_identical(outs[name], _solo(q, False).run(full, N_CHUNKS),
                              name)


def test_sparse_session_skips_and_equals_dense():
    queries = _dash(keyed=True, n=8)
    vals, valid = _pw_stream((K, SPAN * 6), seed=12, rate=0.004)
    grids = {"in": _grid(vals, valid)}
    outs = {}
    for sparse in (False, True):
        sess = MultiQuerySession(SPAN, n_keys=K, sparse=sparse)
        for name, q in queries.items():
            sess.attach(name, q)
        outs[sparse] = sess.run(grids, 6)
    for name in queries:
        _assert_bit_identical(outs[True][name], outs[False][name], name)
    st = sess.runner.dirty_stats()
    assert st["dirty_units"] < st["units"]


def test_union_runner_multi_segment_matches_session():
    """``union_runner`` at several segments per chunk (the session runs
    one) equals the session, dense and sparse."""
    queries = _dash(n=5)
    vals, valid = _pw_stream(SPAN * 8, seed=2, rate=0.02)
    full = {"in": _grid(vals, valid)}
    sess = MultiQuerySession(SPAN)
    for name, q in queries.items():
        sess.attach(name, q)
    want = sess.run(full, 8)
    for body in ("dense", "sparse"):
        r = union_runner(queries, SPAN, ExecPolicy(body=body, dag="union"),
                         segs_per_chunk=4)
        got = r.run(full, 2)
        assert sorted(got) == sorted(queries)
        for name in queries:
            _assert_bit_identical(got[name], want[name], (body, name))
    with pytest.raises(ValueError, match="dag='union'"):
        union_runner(queries, SPAN, ExecPolicy())
    with pytest.raises(ValueError, match="does not match the body"):
        Runner(qc.compile_query(queries["q00"].node, out_len=SPAN),
               ExecPolicy(dag="union"))


# ---------------------------------------------------------------------------
# sharing is real
# ---------------------------------------------------------------------------

def test_shared_aggregate_evaluates_once_per_chunk():
    """16 dashboard queries all read the same window aggregates; the
    instrumented evaluator must run each shared node once per chunk."""
    queries = _dash(n=N_DASH)
    vals, valid = _int_stream(SPAN * N_CHUNKS, seed=5)
    full = {"in": _grid(vals, valid)}
    sess = MultiQuerySession(SPAN, instrument=True)
    for name, q in queries.items():
        sess.attach(name, q)
    sess.run(full, N_CHUNKS)

    s = TStream.source("in", prec=1)
    assert sess.eval_count(s.window(12).mean()) == N_CHUNKS
    assert sess.eval_count(s.window(40).mean()) == N_CHUNKS
    assert sess.eval_count(s) == N_CHUNKS  # the source read itself

    rep = sess.sharing_report()
    assert rep.n_queries == N_DASH
    assert rep.shared_nodes >= 4           # source + fast/slow mean + stddev
    assert rep.union_nodes < rep.independent_nodes
    assert rep.sharing_ratio > 2.0
    snap = sess.metrics.snapshot()
    assert snap["gauges"]["session.union_nodes"]["value"] == rep.union_nodes


def test_cache_interns_across_independently_built_queries():
    cache = SharedPlanCache()
    r1 = {k: cache.intern(v.node) for k, v in _dash(n=4).items()}
    r2 = {k: cache.intern(v.node) for k, v in _dash(n=4).items()}
    for k in r1:
        assert r1[k] is r2[k]  # hash-consing: structural identity == identity


_SUBPROC_QUERY = textwrap.dedent("""
    import sys
    sys.path.insert(0, {src!r})
    from repro_torch.core.frontend import TStream
    from repro_torch.core import ir
    s = TStream.source("in", prec=1)
    fast = s.window(12).mean()
    slow = s.window(40).mean()
    q = (fast.join(slow, lambda a, b: a - b)
         .where(lambda d, t=0.25: d > t))
    print(ir.fingerprint(q.node))
""")


def test_fingerprint_stable_across_processes():
    """Same query, different processes and hash seeds, same fingerprint."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = _SUBPROC_QUERY.format(src=src)
    digests = []
    for seed in ("0", "4242"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        digests.append(out.stdout.strip())
    s = TStream.source("in", prec=1)
    q = (s.window(12).mean().join(s.window(40).mean(), lambda a, b: a - b)
         .where(lambda d, t=0.25: d > t))
    digests.append(ir.fingerprint(q.node))
    assert len(set(digests)) == 1, digests


def test_plan_cache_persist_round_trip(tmp_path):
    path = str(tmp_path / "plans" / "store.pkl")
    q = _dash(n=1)["q00"].node
    exe = qc.compile_query(q, out_len=SPAN, sparse=True)
    art = {"input_specs": exe.input_specs, "change_plan": exe.change_plan,
           "out_len": exe.out_len, "seed_shapes": {"__out": ((1,), "f4")}}
    c1 = SharedPlanCache(persist=path)
    fp = ir.fingerprint(q)
    assert c1.plan_artifact(fp, SPAN) is None
    c1.store_artifact(fp, SPAN, art)
    c2 = SharedPlanCache(persist=path)          # a fresh process's view
    got = c2.plan_artifact(fp, SPAN)
    assert got["input_specs"] == exe.input_specs
    assert got["change_plan"] == exe.change_plan
    assert got["seed_shapes"] == art["seed_shapes"]
    # a torn store, or one naming classes outside the port, degrades to
    # planning and never raises
    with open(path, "wb") as f:
        f.write(b"\x80\x04torn")
    assert SharedPlanCache(persist=path).plan_artifact(fp, SPAN) is None
    import pickle
    with open(path, "wb") as f:
        pickle.dump({"schema": "repro_torch.plans/v1",
                     "plans": {(fp, SPAN): subprocess.Popen}}, f)
    assert SharedPlanCache(persist=path).plan_artifact(fp, SPAN) is None


# ---------------------------------------------------------------------------
# attach / detach mid-run
# ---------------------------------------------------------------------------

def _chunk(full, k):
    sl = slice(k * SPAN, (k + 1) * SPAN)
    return {"in": SnapshotGrid(value=full.value[..., sl],
                               valid=full.valid[..., sl], t0=k * SPAN,
                               prec=1)}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("keyed", [False, True])
def test_attach_detach_matches_fresh_replay_from_checkpoint(keyed, sparse):
    queries = _dash(keyed=keyed, n=6)
    names = list(queries)
    shape = (K, SPAN * (N_CHUNKS + 1)) if keyed else SPAN * (N_CHUNKS + 1)
    vals, valid = _int_stream(shape, seed=6, p_valid=0.9)
    full = _grid(vals, valid)
    kw = dict({"n_keys": K} if keyed else {}, sparse=sparse)

    live = MultiQuerySession(SPAN, **kw)
    for n in names[:3]:
        live.attach(n, queries[n])
    live.step(_chunk(full, 0))
    ckpt1 = live.state()

    live.attach(names[3], queries[names[3]])      # attach mid-run
    o1 = live.step(_chunk(full, 1))
    ckpt2 = live.state()
    live.detach(names[0])                         # detach mid-run
    o2 = live.step(_chunk(full, 2))
    o3 = live.step(_chunk(full, 3))

    fresh = MultiQuerySession(SPAN, **kw)
    for n in names[:4]:
        fresh.attach(n, queries[n])
    fresh.restore(ckpt1)
    p1 = fresh.step(_chunk(full, 1))
    for n in names[:4]:
        _assert_bit_identical(o1[n], p1[n], ("attach", n))

    fresh2 = MultiQuerySession(SPAN, **kw)
    for n in names[1:4]:
        fresh2.attach(n, queries[n])
    fresh2.restore(ckpt2)
    p2 = fresh2.step(_chunk(full, 2))
    p3 = fresh2.step(_chunk(full, 3))
    for n in names[1:4]:
        _assert_bit_identical(o2[n], p2[n], ("detach", n))
        _assert_bit_identical(o3[n], p3[n], ("detach2", n))
    assert o3[names[1]].t0 == p3[names[1]].t0


# ---------------------------------------------------------------------------
# validation / guards
# ---------------------------------------------------------------------------

def test_session_rejects_conflicting_source_declarations():
    sess = MultiQuerySession(SPAN)
    sess.attach("a", TStream.source("in", prec=1).window(8).mean())
    sess.attach("b", TStream.source("in", prec=2).window(8).mean())
    with pytest.raises(ValueError, match="conflicting"):
        sess.step({"in": SnapshotGrid(value=torch.zeros(SPAN),
                                      valid=torch.ones(SPAN, dtype=bool),
                                      t0=0, prec=1)})


def test_session_rejects_keyed_unkeyed_mix():
    sess = MultiQuerySession(SPAN, n_keys=K)
    sess.attach("a", TStream.source("s1", keyed=True).window(8).mean())
    with pytest.raises(ValueError, match="keyed"):
        sess.attach("b", TStream.source("s2", keyed=False).window(8).mean())


def test_session_rejects_lookahead():
    sess = MultiQuerySession(SPAN)
    with pytest.raises(NotImplementedError, match="lookahead"):
        sess.attach("a", TStream.source("in").shift(-4))


def test_detach_clears_keyedness_and_validates_name():
    sess = MultiQuerySession(SPAN, n_keys=K)
    sess.attach("a", TStream.source("s1", keyed=True).window(8).mean())
    with pytest.raises(ValueError, match="no query"):
        sess.detach("nope")
    sess.detach("a")
    # emptied session accepts the other keyedness
    sess.attach("b", TStream.source("s2", keyed=False).window(8).mean())


def test_eval_counts_cleared_on_reset():
    queries = _dash(n=4)
    vals, valid = _int_stream(SPAN * 2, seed=8)
    full = {"in": _grid(vals, valid)}
    sess = MultiQuerySession(SPAN, instrument=True)
    for name, q in queries.items():
        sess.attach(name, q)
    sess.run(full, 2)
    sess.reset()
    sess.run(full, 2)  # warmup-then-measure pattern must not double-count
    s = TStream.source("in", prec=1)
    assert sess.eval_count(s.window(12).mean()) == 2


def test_union_plan_merges_halo_contracts():
    a = TStream.source("in", prec=1).window(16).mean()
    b = TStream.source("in", prec=1).window(48).mean()
    up = qplan.plan_union([a.node, b.node], span=SPAN)
    assert up.input_specs["in"].left_halo == 48    # union of 16 and 48
    pa = qplan.plan_query(a.node, out_len=SPAN)
    assert pa.input_specs["in"].left_halo == 16
    cp = qplan.plan_change(up)
    assert cp.specs["in"].lookback == 48
    with pytest.raises(ValueError, match="at least one"):
        qplan.plan_union([], SPAN)
    with pytest.raises(ValueError, match="not a multiple"):
        qplan.plan_union([TStream.source("in", prec=3).window(6).mean()
                          .node], 64)


def test_session_step_shape_check_is_real_exception():
    vals, valid = _int_stream(SPAN, seed=14)
    sess = MultiQuerySession(SPAN)
    sess.attach("q", TStream.source("in", prec=1).window(8).mean())
    bad = {"in": _grid(vals[:SPAN - 1], valid[:SPAN - 1])}
    with pytest.raises(ValueError, match="chunk validity shape"):
        sess.step(bad)


def test_mesh_and_time_sharding_raise_naming_a14():
    """Mesh placement is ported (ROADMAP A14): what still raises is what
    the reference refuses — a mesh over an unkeyed session (it shards the
    key axis), and time-sharding keyed sources."""
    mesh = make_local_mesh(n_data=1, device="cpu")
    sess = MultiQuerySession(SPAN, mesh=mesh)
    with pytest.raises(ValueError, match="requires keyed"):
        sess.attach("q", TStream.source("in", prec=1).window(8).mean())
    with pytest.raises(NotImplementedError, match="time-shards unkeyed"):
        shard_union_run({"q": TStream.source("in", keyed=True).window(8)
                         .mean()}, SPAN, {}, mesh)


def test_halo_overflow_guard_reports_hop_geometry():
    """Any halo is served by the multi-hop exchange, so nothing raises;
    the report keeps the single-hop threshold formula, as the
    reference's."""
    q = TStream.source("in", prec=1).window(100).mean()
    exe = qc.compile_query(q.node, out_len=32)
    rep = check_single_hop_halo(exe.input_specs, exe.out_prec, n=4)
    assert rep["in"].min_single_hop_out_len == 100
    assert rep["in"].left_hops == 4 and rep["in"].right_hops == 0
    assert rep["in"].max_hops == 4
    assert check_single_hop_halo(exe.input_specs, exe.out_prec,
                                 n=1)["in"].max_hops == 0
    rq = RTStream.source("in", prec=1).window(100).mean()
    from repro.core import compile as rqc
    rexe = rqc.compile_query(rq.node, out_len=32, pallas=False)
    want = r_check_hops(rexe.input_specs, rexe.out_prec, n=4)["in"]
    assert (rep["in"].left_hops, rep["in"].right_hops,
            rep["in"].min_single_hop_out_len) == (
        want.left_hops, want.right_hops, want.min_single_hop_out_len)


def test_shard_union_run_single_device_matches_session():
    """Time-sharded union execution on the 1-rank mesh matches the chunked
    session and the reference's ``shard_union_run`` on its 1-device mesh
    bit for bit (integer-valued data)."""
    N = 128
    vals, valid = _int_stream(N, seed=13)
    s = TStream.source("in", prec=1)
    queries = {"a": s.window(12).mean(), "b": s.window(40).sum()}
    out = shard_union_run(queries, N, {"in": _grid(vals, valid)},
                          make_local_mesh(n_data=1, device="cpu"))
    sess = MultiQuerySession(N)
    for name, q in queries.items():
        sess.attach(name, q)
    ref = sess.run({"in": _grid(vals, valid)}, 1)
    rs = RTStream.source("in", prec=1)
    want = r_shard_union_run(
        {"a": rs.window(12).mean(), "b": rs.window(40).sum()}, N,
        {"in": RGrid(value=jnp.asarray(vals), valid=jnp.asarray(valid),
                     t0=0, prec=1)}, r_make_local_mesh(n_data=1),
        pallas=False)
    for name in queries:
        assert out[name].t0 == 0
        _assert_bit_identical(out[name], ref[name], name)
        _assert_bit_identical(out[name], want[name], name)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _rgrid(vals, valid):
    return RGrid(value=jnp.asarray(vals), valid=jnp.asarray(valid), t0=0,
                 prec=1)


def _rchunk(full, k, keyed):
    sl = slice(k * SPAN, (k + 1) * SPAN)
    if keyed:
        return {"in": RGrid(value=full.value[:, sl], valid=full.valid[:, sl],
                            t0=k * SPAN, prec=1)}
    return {"in": RGrid(value=full.value[sl], valid=full.valid[sl],
                        t0=k * SPAN, prec=1)}


def test_plan_union_matches_reference():
    q, rq = _dash(n=6), _dash(n=6, pkg=RA)
    for span in (SPAN, 3 * SPAN):
        up = qplan.plan_union([v.node for v in q.values()], span)
        rup = rplan.plan_union([v.node for v in rq.values()], span)
        assert (up.out_len, up.out_prec, up.span) == (rup.out_len,
                                                      rup.out_prec, rup.span)
        assert sorted(up.input_specs) == sorted(rup.input_specs)
        for name, s in up.input_specs.items():
            r = rup.input_specs[name]
            assert (s.t0, s.length, s.prec, s.core) == (r.t0, r.length,
                                                        r.prec, r.core)
        assert_node_grids(ir.topo_order_multi(list(up.roots)),
                          rir.topo_order_multi(list(rup.roots)), up, rup,
                          list(rup.roots))
        cp, rcp = qplan.plan_change(up), rplan.plan_change(rup)
        assert cp.out_len == rcp.out_len and cp.out_prec == rcp.out_prec
        for name, sp in cp.specs.items():
            r = rcp.specs[name]
            assert (sp.lookback, sp.lookahead, sp.prec) == (
                r.lookback, r.lookahead, r.prec)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("keyed", [False, True])
def test_session_matches_reference_through_attach_and_detach(keyed, sparse):
    """The same chunks into both packages' sessions, with a query attached
    and one detached between chunks: every output bit for bit."""
    queries, rqueries = _dash(keyed=keyed, n=6), _dash(keyed=keyed, n=6,
                                                       pkg=RA)
    names = list(queries)
    n_chunks = 5
    shape = (K, SPAN * n_chunks) if keyed else SPAN * n_chunks
    vals, valid = _int_stream(shape, seed=31, p_valid=0.9, top=16)
    full, rfull = _grid(vals, valid), _rgrid(vals, valid)
    kw = dict({"n_keys": K} if keyed else {}, sparse=sparse)
    sess = MultiQuerySession(SPAN, **kw)
    rsess = RSession(SPAN, pallas=False, **kw)
    for n in names[:4]:
        sess.attach(n, queries[n])
        rsess.attach(n, rqueries[n])
    for c in range(n_chunks):
        if c == 2:
            sess.attach(names[4], queries[names[4]])
            rsess.attach(names[4], rqueries[names[4]])
        if c == 3:
            sess.detach(names[1])
            rsess.detach(names[1])
        got = sess.step(_chunk(full, c))
        want = rsess.step(_rchunk(rfull, c, keyed))
        assert sorted(got) == sorted(want)
        for n in got:
            _assert_head(got[n], want[n], n, (c, n))


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("keyed", [False, True])
def test_reference_state_continues_in_the_port(keyed, sparse):
    """A reference session run for k chunks, its ``state()`` carried into
    the port through ``convert.state_from_numpy``, then continued in both:
    equal outputs."""
    queries, rqueries = _dash(keyed=keyed, n=6), _dash(keyed=keyed, n=6,
                                                       pkg=RA)
    n_chunks, k = 5, 2
    shape = (K, SPAN * n_chunks) if keyed else SPAN * n_chunks
    vals, valid = _int_stream(shape, seed=41, p_valid=0.9, top=16)
    full, rfull = _grid(vals, valid), _rgrid(vals, valid)
    kw = dict({"n_keys": K} if keyed else {}, sparse=sparse)
    rsess = RSession(SPAN, pallas=False, **kw)
    for n, q in rqueries.items():
        rsess.attach(n, q)
    for c in range(k):
        rsess.step(_rchunk(rfull, c, keyed))
    state = convert.state_from_numpy(rsess.state(), device="cpu")
    sess = MultiQuerySession(SPAN, **kw)
    for n, q in queries.items():
        sess.attach(n, q)
    sess.restore(state)
    for c in range(k, n_chunks):
        got = sess.step(_chunk(full, c))
        want = rsess.step(_rchunk(rfull, c, keyed))
        assert all(g.t0 == c * SPAN for g in got.values())
        for n in got:
            _assert_head(got[n], want[n], n, (c, n))
    # and back: the port's state continues in the reference
    back = convert.state_to_numpy(sess.state())
    rsess2 = RSession(SPAN, pallas=False, **kw)
    for n, q in rqueries.items():
        rsess2.attach(n, q)
    rsess2.restore(back)
    assert rsess2.state()["__t"] == n_chunks * SPAN


@pytest.mark.parametrize("sparse", [False, True])
def test_keyed_mesh_session_matches_reference_through_attach_and_detach(
        sparse):
    """A keyed session with ``mesh=`` on the 1-rank mesh and the
    reference's on its 1-device mesh, fed the same chunks with a query
    attached and one detached between chunks: every output bit for bit
    (the stddev heads within ``STD_TOL``)."""
    import jax
    queries, rqueries = _dash(keyed=True, n=6), _dash(keyed=True, n=6,
                                                      pkg=RA)
    names = list(queries)
    n_chunks = 4
    vals, valid = _int_stream((K, SPAN * n_chunks), seed=37, p_valid=0.9,
                              top=16)
    full, rfull = _grid(vals, valid), _rgrid(vals, valid)
    sess = MultiQuerySession(SPAN, n_keys=K, sparse=sparse,
                             mesh=make_local_mesh(n_data=1, device="cpu"))
    rsess = RSession(SPAN, n_keys=K, sparse=sparse, pallas=False,
                     mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                            ("data",)))
    for n in names[:4]:
        sess.attach(n, queries[n])
        rsess.attach(n, rqueries[n])
    for c in range(n_chunks):
        if c == 1:
            sess.attach(names[4], queries[names[4]])
            rsess.attach(names[4], rqueries[names[4]])
        if c == 2:
            sess.detach(names[1])
            rsess.detach(names[1])
        got = sess.step(_chunk(full, c))
        want = rsess.step(_rchunk(rfull, c, True))
        assert sorted(got) == sorted(want)
        for n in got:
            _assert_head(got[n], want[n], n, (c, n))
    assert sess.runner.policy.describe() == (
        f"{'sparse' if sparse else 'dense'}×vmapped×mesh1×union")


def test_shard_union_run_evaluates_shared_nodes_once(monkeypatch):
    """``shard_union_run`` interns its queries, so a node shared between
    queries evaluates once per call, as in the session: the evaluator runs
    exactly the union DAG's nodes (the reference gets this from XLA's CSE
    under ``jit``)."""
    from repro_torch.multiquery import session as sess_mod
    qs = _dash(n=8)
    calls = []
    real = qcompile_eval = sess_mod.qcompile.eval_op

    def counting(n, *args):
        calls.append(id(n))
        return real(n, *args)

    monkeypatch.setattr(sess_mod.qcompile, "eval_op", counting)
    vals, valid = _int_stream(SPAN, seed=41)
    shard_union_run(qs, SPAN, {"in": _grid(vals, valid)},
                    make_local_mesh(n_data=1, device="cpu"))
    monkeypatch.setattr(sess_mod.qcompile, "eval_op", qcompile_eval)
    sess = MultiQuerySession(SPAN)
    for name, q in qs.items():
        sess.attach(name, q)
    rep = sess.sharing_report()
    assert rep.shared_nodes > 0
    assert len(calls) == len(set(calls)) == rep.union_nodes
