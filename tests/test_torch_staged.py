"""The one-shot paths staged as the reference's ``jax.jit`` stages them:
``CompiledQuery.fn`` (``compile_query(..., jit=True)``), ``trace_fn``,
``partition_run``, ``run_interpreted``, ``batch_run`` and ``sparse_run``
through :class:`repro_torch.engine.capture.Staged` and
:class:`~repro_torch.engine.capture.StagedSwitch`.

On the CPU a staged call runs its eager body over the same static input
buffers a captured graph reads on the card, so these tests cover the
buffer plumbing: windows written into the buffers with φ off the grid's
ends, outputs copied out of them, entries bounded and rebuilt.  The same
numpy data goes through the jitted reference (``pallas=False``, as
``tests/test_torch_query.py`` runs it) and through the port.

Integer data: every app's output is bit-identical to the reference's
where the query's arithmetic is exact in f32 (impute, pantomkins,
resample, trend, ysb: sums, differences, gates and interpolation of
integers).  fraud, rsi, vibration and znorm divide or take roots of the
window sums, which XLA's CPU code rounds in another order than PyTorch
(a few ulps, as ``tests/test_torch_query.py`` holds them), so those are
held within ``repro_torch.data.tolerance``.  Within the port, staged and
``jit=False`` are the same program and must agree bit for bit
everywhere, for every app.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import compile as rqc
from repro.core import parallel as rpar
from repro.core import sparse as rsp
from repro.core.frontend import TStream as RTStream
from repro.core.stream import SnapshotGrid as RGrid
from repro.data import apps as rapps
from repro_torch import obs
from repro_torch.core import compile as qc
from repro_torch.core import parallel as par
from repro_torch.core import sparse as sp
from repro_torch.core.frontend import TStream
from repro_torch.core.stream import SnapshotGrid
from repro_torch.data import apps, streams, tolerance
from repro_torch.engine import capture

N, PART = 2048, 512
KEYS, KEY_TICKS = 8, 300
EXACT_APPS = {"impute", "pantomkins", "resample", "trend", "ysb"}


def _intify(data):
    """The apps' inputs floored to integers (validity kept)."""
    out = {}
    for name, d in data.items():
        v = d["value"]
        out[name] = {"value": ({k: np.floor(a) for k, a in v.items()}
                               if isinstance(v, dict) else np.floor(v)),
                     "valid": d["valid"]}
    return out


def _ref_grids(data):
    out = {}
    for name, d in data.items():
        val = d["value"]
        v = ({k: jnp.asarray(a, jnp.float32) for k, a in val.items()}
             if isinstance(val, dict) else jnp.asarray(val, jnp.float32))
        out[name] = RGrid(value=v, valid=jnp.asarray(d["valid"]), t0=0,
                          prec=1)
    return out


def _leaves(v):
    if isinstance(v, dict):
        return {k: np.asarray(a.numpy() if torch.is_tensor(a) else a)
                for k, a in v.items()}
    return {"v": np.asarray(v.numpy() if torch.is_tensor(v) else v)}


def _hold_to_ref(name, got, want):
    """Bit for bit at the valid ticks for the exact apps, within
    ``tolerance`` for the others; validity equal either way."""
    if name not in EXACT_APPS:
        tolerance.compare(name, got.valid.numpy(), _leaves(got.value),
                          np.asarray(want.valid), _leaves(want.value))
        return
    m = got.valid.numpy()
    assert np.array_equal(m, np.asarray(want.valid))
    gv, wv = _leaves(got.value), _leaves(want.value)
    for k in gv:
        assert gv[k].dtype == wv[k].dtype
        assert np.array_equal(gv[k][m], wv[k][m]), k


def _same_bits(a, b):
    """Two port grids equal everywhere, φ ticks and NaN included."""
    assert a.t0 == b.t0 and a.prec == b.prec
    assert torch.equal(a.valid, b.valid)
    la, lb = _leaves(a.value), _leaves(b.value)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype
        assert np.array_equal(la[k], lb[k], equal_nan=True), k


def _app_exes(name, algo="block"):
    app, rapp = apps.make_app(name), rapps.make_app(name)
    out_len = PART // app.query.prec
    exe = qc.compile_query(app.query.node, out_len=out_len, sum_algo=algo)
    eager = qc.compile_query(app.query.node, out_len=out_len,
                             sum_algo=algo, jit=False)
    rexe = rqc.compile_query(rapp.query.node, out_len=out_len,
                             pallas=False, sum_algo=algo)
    return app, exe, eager, rexe


# out_t0 = 0: the first partition's lookback falls before the grid (left
# φ padding); out_t0 = 300: no partition starts on the grid's origin and
# the last one's window (and the lookahead apps' right halo) runs off its
# end (right φ padding)
@pytest.mark.parametrize("out_t0", [0, 300])
@pytest.mark.parametrize("algo", ["block", "soe"])
@pytest.mark.parametrize("name", sorted(rapps.APPS))
def test_partition_run_integer_data_matches_reference(name, algo, out_t0):
    app, exe, eager, rexe = _app_exes(name, algo)
    data = _intify(app.make_input(N, 3))
    grids = apps.make_grids(data, device="cpu")
    n_parts = N // (exe.out_len * exe.out_prec)
    got = par.partition_run(exe, grids, out_t0, n_parts)
    assert isinstance(exe.fn, capture.Staged)
    _same_bits(got, par.partition_run(eager, grids, out_t0, n_parts))
    want = rpar.partition_run(rexe, _ref_grids(data), out_t0, n_parts)
    _hold_to_ref(name, got, want)


@pytest.mark.parametrize("name", sorted(rapps.APPS))
def test_partition_run_interpreted_matches_reference(name):
    """One staged graph per node (on the CPU: one buffered evaluation per
    node), with the barrier after each: the same bits as the fused run,
    and the reference's interpreted run (one ``jit`` per node)."""
    app, exe, _eager, rexe = _app_exes(name)
    data = _intify(app.make_input(N // 2, 4))
    grids = apps.make_grids(data, device="cpu")
    n_parts = (N // 2) // (exe.out_len * exe.out_prec)
    got = par.partition_run(exe, grids, 0, n_parts, interpreted=True)
    assert all(isinstance(f, capture.Staged) for _, f, _, _ in exe._node_fns)
    _same_bits(got, par.partition_run(exe, grids, 0, n_parts))
    want = rpar.partition_run(rexe, _ref_grids(data), 0, n_parts,
                              interpreted=True)
    _hold_to_ref(name, got, want)


@pytest.mark.parametrize("name", sorted(rapps.APPS))
def test_partition_run_float_data_within_tolerance(name):
    app, exe, eager, rexe = _app_exes(name)
    data = app.make_input(N, 5)
    grids = apps.make_grids(data, device="cpu")
    n_parts = N // (exe.out_len * exe.out_prec) - 1
    got = par.partition_run(exe, grids, 300, n_parts)
    _same_bits(got, par.partition_run(eager, grids, 300, n_parts))
    want = rpar.partition_run(rexe, _ref_grids(data), 300, n_parts)
    tolerance.compare(name, got.valid.numpy(), _leaves(got.value),
                      np.asarray(want.valid), _leaves(want.value))


@pytest.mark.parametrize("name", sorted(rapps.KEYED_APPS))
def test_batch_run_keyed_matches_reference(name):
    """The halo pads written into the staged buffer around the grid, one
    evaluation over every key: equal to ``jit=False`` (``F.pad``) bit for
    bit and to the reference's ``jit(vmap(...))``."""
    app, rapp = apps.make_keyed_app(name), rapps.make_keyed_app(name)
    data = _intify(app.make_keyed_input(KEYS, KEY_TICKS, 7))
    out_len = KEY_TICKS // app.query.prec
    exe = qc.compile_query(app.query.node, out_len=out_len)
    eager = qc.compile_query(app.query.node, out_len=out_len, jit=False)
    rexe = rqc.compile_query(rapp.query.node, out_len=out_len, pallas=False)
    grids = apps.make_grids(data, device="cpu")
    got = par.batch_run(exe, grids)
    assert got.valid.shape == (KEYS, out_len)
    _same_bits(got, par.batch_run(eager, grids))
    _hold_to_ref(name, got, rpar.batch_run(rexe, _ref_grids(data)))


def _burst(n, rate, seed):
    vals = streams.burst_stream(n, rate, seed)
    return vals, np.ones(n, bool)


def _sparse_query(S):
    """Exact in f32 on integer data: a trailing sum against a trailing
    max, gated."""
    s = S.source("in", prec=1)
    return (s.window(32).sum()
            .join(s.window(8).max().shift(1), lambda a, b: a - 4 * b)
            .where(lambda d: d > 0))


@pytest.mark.parametrize("dirty_input", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.01, 1.0])
@pytest.mark.parametrize("fused", [True, False])
def test_sparse_run_matches_reference_and_counts_as_it(fused, rate,
                                                       dirty_input):
    """The fused run (prefix, one body per capacity rung picked from the
    count, suffix) and the three-phase one, against the reference's, with
    the ``sparse.dirty_segments`` counter moving as the reference's does
    (the fused one by a lazy device add: a tensor, read at snapshot)."""
    seg, n = 64, 2048
    vals, valid = _burst(n, rate, 3)
    exe = qc.compile_query(_sparse_query(TStream).node, out_len=seg,
                           sparse=True)
    rexe = rqc.compile_query(_sparse_query(RTStream).node, out_len=seg,
                             sparse=True, pallas=False)
    g = {"in": SnapshotGrid(value=torch.from_numpy(vals.copy()),
                            valid=torch.from_numpy(valid), t0=0, prec=1)}
    rg = {"in": RGrid(value=jnp.asarray(vals), valid=jnp.asarray(valid),
                      t0=0, prec=1)}
    dirty = rdirty = None
    if dirty_input:
        d = np.zeros(n, bool)
        d[::97] = True
        dirty, rdirty = {"in": torch.from_numpy(d)}, {"in": jnp.asarray(d)}
    s0, r0 = obs.default().snapshot(), robs.default().snapshot()
    got = sp.sparse_run(exe, g, 0, n // seg, dirty=dirty, fused=fused)
    want = rsp.sparse_run(rexe, rg, 0, n // seg, dirty=rdirty, fused=fused)
    s1, r1 = obs.default().snapshot(), robs.default().snapshot()
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    m = got.valid.numpy()
    assert np.array_equal(got.value.numpy()[m], np.asarray(want.value)[m])
    for name in ("sparse.dirty_segments", "sparse.segments"):
        assert (obs.counter_delta(s0, s1, name)
                == robs.counter_delta(r0, r1, name)), name
    if not dirty_input:
        # sparse ≡ dense on the same partitioning, bit for bit
        _same_bits(got, par.partition_run(exe, g, 0, n // seg))


@pytest.mark.parametrize("fused", [True, False])
def test_sparse_run_jit_false_is_the_eager_twin(fused):
    """``jit=False``: the fused run's parts eagerly, its count read on the
    host (no switch staged) — the same bits and the same dirty count as
    the staged run."""
    seg, n = 64, 2048
    vals, valid = _burst(n, 0.01, 4)
    g = {"in": SnapshotGrid(value=torch.from_numpy(vals.copy()),
                            valid=torch.from_numpy(valid), t0=0, prec=1)}
    got = []
    for jit in (True, False):
        exe = qc.compile_query(_sparse_query(TStream).node, out_len=seg,
                               sparse=True, jit=jit)
        s0 = obs.default().snapshot()
        out = sp.sparse_run(exe, g, 0, n // seg, fused=fused)
        got.append((out, obs.counter_delta(s0, obs.default().snapshot(),
                                           "sparse.dirty_segments")))
        steps = (exe.__dict__.get("_sparse_fused_steps", {}).values()
                 if fused else exe._sparse_step_cache.values())
        assert all(isinstance(st, (capture.Staged, capture.StagedSwitch))
                   == jit for st in steps) and steps
    _same_bits(got[0][0], got[1][0])
    assert got[0][1] == got[1][1] and 0 < got[0][1] < n // seg


def test_fused_sparse_run_builds_one_switch_per_geometry():
    """One staged switch per plan, one entry per input geometry; the
    bodies cover every capacity rung, the last the dense one."""
    exe = qc.compile_query(streams.fraud_query(32).node, out_len=64,
                           sparse=True)
    vals, valid = _burst(1024, 0.01, 1)
    g = {"in": SnapshotGrid(value=torch.from_numpy(vals.copy()),
                            valid=torch.from_numpy(valid), t0=0, prec=1)}
    for _ in range(3):
        sp.sparse_run(exe, g, 0, 16)
    (step,) = exe._sparse_fused_steps.values()
    assert isinstance(step, capture.StagedSwitch)
    assert len(step.entries) == 1
    assert step.parts[3] == sp.capacity_ladder(16)


def test_jit_false_is_the_eager_body_and_trace_fn_is_it():
    """``trace_fn`` is the eager body in both modes (the reference's
    meaning: its unjitted traceable body); ``fn`` is it under
    ``jit=False`` and a :class:`Staged` over it under ``jit=True``."""
    app = apps.make_app("trend")
    staged = qc.compile_query(app.query.node, out_len=256)
    eager = qc.compile_query(app.query.node, out_len=256, jit=False)
    assert eager.fn is eager.trace_fn
    assert isinstance(staged.fn, capture.Staged)
    assert staged.fn.fn is staged.trace_fn
    assert not any(isinstance(f, capture.Staged)
                   for _, f, _, _ in eager._node_fns)
    rexe = rqc.compile_query(rapps.make_app("trend").query.node,
                             out_len=256, pallas=False)
    assert callable(rexe.trace_fn) and rexe.fn is not rexe.trace_fn
    spec = staged.input_specs["in"]
    g = par.slice_grid(apps.make_grids(_intify(app.make_input(1024, 2)),
                                       device="cpu")["in"],
                       spec.t0, spec.t0 + spec.length)
    inp = {"in": (g.value, g.valid)}
    for a, b in zip(staged.fn(inp), staged.trace_fn(inp)):
        assert torch.equal(a, b)


def test_a_result_survives_later_calls_with_other_inputs():
    """No staged path hands out its static outputs: a result stays as it
    was after later calls of the same geometry on other data."""
    app = apps.make_app("trend")
    exe = qc.compile_query(app.query.node, out_len=256, sparse=True)
    one = apps.make_grids(_intify(app.make_input(1024, 1)), device="cpu")
    two = apps.make_grids(_intify(app.make_input(1024, 2)), device="cpu")
    spec = exe.input_specs["in"]

    def window(grids):
        g = par.slice_grid(grids["in"], spec.t0, spec.t0 + spec.length)
        return {"in": (g.value, g.valid)}

    def leaves(r):
        if isinstance(r, SnapshotGrid):
            r = (r.value, r.valid)
        return torch.utils._pytree.tree_leaves(r)

    # a bare source: its output is a view of the input, so on the CPU too
    # only the copy out keeps it from the next call's buffer
    bare = qc.compile_query(TStream.source("in", prec=1).node, out_len=256)
    calls = [lambda gr: exe.fn(window(gr)),
             lambda gr: bare.fn({"in": (gr["in"].value[:256],
                                        gr["in"].valid[:256])}),
             lambda gr: par.partition_run(exe, gr, 0, 4),
             lambda gr: par.batch_run(exe, gr),
             lambda gr: sp.sparse_run(exe, gr, 0, 4),
             lambda gr: sp.sparse_run(exe, gr, 0, 4, fused=False)]
    for call in calls:
        first = call(one)
        kept = [x.clone() for x in leaves(first)]
        call(two)
        now = leaves(first)
        assert all(torch.equal(a, b) for a, b in zip(kept, now))
        assert not all(torch.equal(a, b)
                       for a, b in zip(now, leaves(call(two))))


def test_staged_entries_are_bounded_and_an_evicted_one_rebuilds(
        monkeypatch):
    """At most ``STAGED_CACHE_MAX`` geometries stay staged (least recently
    used first out); an evicted geometry builds a new entry and computes
    what it computed before."""
    calls = []

    def fn(x, scale):
        calls.append(tuple(x.shape))
        return {"y": x * scale, "n": x.sum(dim=-1)}

    monkeypatch.setattr(capture, "STAGED_CACHE_MAX", 2)
    st = capture.Staged(fn)
    xs = [torch.arange(k * 3, dtype=torch.float32).reshape(k, 3)
          for k in (1, 2, 3)]
    first = [st(x, 2.0) for x in xs]
    assert len(st.entries) == 2
    assert [k[1][0][1] for k in st.entries] == [(2, 3), (3, 3)]
    again = st(xs[0], 2.0)                  # evicted: a new entry
    assert len(st.entries) == 2 and calls[-1] == (1, 3)
    assert torch.equal(again["y"], first[0]["y"])
    assert torch.equal(again["n"], first[0]["n"])
    # a static argument is part of the geometry
    st(xs[0], 3.0)
    assert len(st.entries) == 2
    assert torch.equal(st(xs[0], 3.0)["y"], xs[0] * 3.0)


def test_staged_geometry_is_shape_dtype_device_not_strides():
    """The buffers are contiguous, so the caller's strides never reach
    the staged body: a transposed view shares the contiguous input's
    entry, another dtype or shape does not."""
    st = capture.Staged(lambda x: x + 1)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    st(x)
    st(x.t().contiguous().t())          # same shape, other strides
    assert len(st.entries) == 1
    st(x.double())
    st(x[:2])
    assert len(st.entries) == 3
    assert torch.equal(st(x.t().contiguous().t()), x + 1)


def test_staged_switch_picks_the_body_by_the_count():
    """On the CPU the count is read on the host and picks the first body
    whose capacity is at or above it (the last past the end), as
    ``pick_bucket_kernel`` does on the card."""
    sw = capture.StagedSwitch(
        lambda x: (x, (x > 0).sum(dtype=torch.int32)),
        [lambda x, c=c: x * 0 + c for c in (10, 20, 30)],
        lambda out, count: (out, count.clone()), caps=[1, 2, 4])
    for vals, cap in (([0, 0, 0, 0, 0], 10), ([1, 0, 0, 0, 0], 10),
                      ([1, 1, 0, 0, 0], 20), ([1, 1, 1, 0, 0], 30),
                      ([1, 1, 1, 1, 1], 30)):
        out, count = sw(torch.tensor(vals))
        assert int(count) == sum(vals) and bool((out == cap).all())
    assert len(sw.entries) == 1


def test_staged_entry_by_spec_is_the_tensors_entry():
    """A :class:`capture.Spec` leaf names the geometry a tensor would: the
    entry a caller fills itself (a partition's window) is the one a call
    with tensors of that geometry finds, its buffer zeros until loaded."""
    st = capture.Staged(lambda d: d["x"] * 2)
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ent = st.entry({"x": capture.Spec(x.device, (2, 3), x.dtype)})
    (buf,) = ent.inputs
    assert buf["x"].shape == (2, 3) and not buf["x"].any()
    buf["x"].copy_(x)
    assert torch.equal(st.run(ent), x * 2)
    assert torch.equal(st({"x": x + 1}), (x + 1) * 2)
    assert len(st.entries) == 1
    st.entry({"x": capture.Spec(x.device, (2, 3), torch.float64)})
    assert len(st.entries) == 2


def test_batch_run_halos_stay_zero_in_its_own_buffers():
    """``batch_run`` stages ``trace_fn`` over buffers of the padded
    shapes, its own (``partition_run`` at the same shapes writes data
    where ``batch_run`` keeps its halos): only the grids' ticks are
    written, the halo ticks stay zero across calls on other data, and the
    results stay equal to ``jit=False`` (``F.pad``) bit for bit."""
    app = apps.make_keyed_app("trend")
    out_len = KEY_TICKS // app.query.prec
    exe = qc.compile_query(app.query.node, out_len=out_len)
    eager = qc.compile_query(app.query.node, out_len=out_len, jit=False)
    (spec,) = exe.input_specs.values()
    assert spec.left_halo > 0
    for seed in (3, 4):
        grids = apps.make_grids(
            _intify(app.make_keyed_input(KEYS, KEY_TICKS, seed)),
            device="cpu")
        # the same shapes through partition_run, whose windows carry data
        # in the first left_halo ticks
        wide = apps.make_grids(
            _intify(app.make_keyed_input(KEYS, 2 * KEY_TICKS, seed)),
            device="cpu")
        par.partition_run(exe, wide, KEY_TICKS, 1)
        _same_bits(par.batch_run(exe, grids), par.batch_run(eager, grids))
    (ent,) = exe._batch_stage.entries.values()
    ((value, valid),) = ent.inputs[0].values()
    assert valid.shape == (KEYS, spec.left_halo + KEY_TICKS)
    assert not valid[..., :spec.left_halo].any()
    assert not value[..., :spec.left_halo].any()
    assert valid[..., spec.left_halo:].all()
