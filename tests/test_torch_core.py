"""Port core against the reference: grids, IR passes, boundary resolution,
planning artifacts and reductions, field by field, on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundary as rboundary
from repro.core import compile as rqc
from repro.core import fusion as rfusion
from repro.core import halo as rhalo
from repro.core import ir as rir
from repro.core import parallel as rpar
from repro.core import plan as rplan
from repro.core import reduction as rreduction
from repro.core import stream as rstream
from repro.core.frontend import TStream as RTStream
from repro.data import apps as rapps
from repro.engine import ExecPolicy as RPolicy, Runner as RRunner
from repro_torch.core import boundary, fusion, halo, ir, plan, reduction
from repro_torch.core import compile as qc
from repro_torch.core import parallel as par
from repro_torch.core import stream
from repro_torch.core.frontend import TStream
from repro_torch.data import apps, tolerance
from repro_torch.engine import ExecPolicy, Runner
from torch_plan_common import assert_node_grids

APP_NAMES = sorted(apps.APPS)

EVENT_CASES = [
    ([(2, 5, 7.0)], 0, 8, 1),
    ([(0, 3, 1.0), (5, 6, 2.0), (6, 9, 3.0)], 0, 10, 1),
    ([(0, 10, 1.0), (3, 6, 2.0)], 0, 10, 1),          # overlap: latest wins
    ([(-4, 3, 1.5), (7, 40, -2.0), (12, 13, 4.0)], -4, 36, 4),
    ([(1, 4, {"a": 1.0, "b": 2.0}), (4, 9, {"a": 3.0, "b": -1.0})],
     0, 12, 2),
]


@pytest.mark.parametrize("evs,t0,t_end,prec", EVENT_CASES)
def test_events_to_grid_matches_reference(evs, t0, t_end, prec):
    ref = rstream.events_to_grid(
        rstream.EventStream([rstream.Event(*e) for e in evs]), t0, t_end,
        prec)
    got = stream.events_to_grid(
        stream.EventStream([stream.Event(*e) for e in evs]), t0, t_end,
        prec, device="cpu")
    assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    if isinstance(ref.value, dict):
        assert got.value.keys() == ref.value.keys()
        for k in ref.value:
            assert np.array_equal(got.value[k].numpy(),
                                  np.asarray(ref.value[k]))
    else:
        assert got.value.dtype == torch.float32
        assert np.array_equal(got.value.numpy(), np.asarray(ref.value))
    back = [(e.start, e.end, e.payload) for e in stream.grid_to_events(got)]
    want = [(e.start, e.end, e.payload) for e in rstream.grid_to_events(ref)]
    assert back == want


def _queries(name):
    return rapps.make_app(name).query.node, apps.make_app(name).query.node


@pytest.mark.parametrize("name", APP_NAMES)
def test_fusion_report_matches_reference(name):
    rq, q = _queries(name)
    assert (fusion.fusion_report(q, fusion.optimize(q))
            == rfusion.fusion_report(rq, rfusion.optimize(rq)))


@pytest.mark.parametrize("name", APP_NAMES)
def test_boundary_resolve_matches_reference(name):
    rq, q = _queries(name)
    for f_r, f in ((lambda x: x, lambda x: x),
                   (rfusion.optimize, fusion.optimize)):
        want = {k: (b.lookback, b.lookahead)
                for k, b in rboundary.resolve(f_r(rq)).items()}
        got = {k: (b.lookback, b.lookahead)
               for k, b in boundary.resolve(f(q)).items()}
        assert got == want
    assert boundary.halo_ticks(q) == rboundary.halo_ticks(rq)


@pytest.mark.parametrize("name", APP_NAMES)
@pytest.mark.parametrize("out_len", [64, 1000])
def test_plan_query_matches_reference(name, out_len):
    rq, q = _queries(name)
    rp = rplan.plan_query(rfusion.optimize(rq), out_len)
    p = plan.plan_query(fusion.optimize(q), out_len)
    assert (p.out_len, p.out_prec) == (rp.out_len, rp.out_prec)

    def spec_fields(s):
        return (s.t0, s.length, s.prec, s.core, s.left_halo, s.right_halo,
                s.contract_t())

    assert ({k: spec_fields(s) for k, s in p.input_specs.items()}
            == {k: spec_fields(s) for k, s in rp.input_specs.items()})
    # node grids, in topological order of the optimized DAGs: the
    # reference's, but where a Reduce reads the node, which begins at the
    # exact demand
    assert_node_grids(ir.topo_order(p.root), rir.topo_order(rp.root), p, rp,
                      [rp.root])
    for name_, s in p.input_specs.items():
        rs = rp.input_specs[name_].halo_schedule()
        hs = s.halo_schedule()
        assert (hs.core, hs.left_hops, hs.right_hops) == (
            rs.core, rs.left_hops, rs.right_hops)


@pytest.mark.parametrize("halo_,core", [(0, 5), (5, 5), (6, 5), (37, 8)])
def test_halo_schedule_matches_reference(halo_, core):
    assert halo.hop_count(halo_, core) == rhalo.hop_count(halo_, core)
    s, rs = halo.schedule(halo_, 3, core), rhalo.schedule(halo_, 3, core)
    assert (s.left_hops, s.right_hops, s.max_hops) == (
        rs.left_hops, rs.right_hops, rs.max_hops)


def test_fingerprint_matches_reference_on_function_free_queries():
    """Queries with no user functions tokenize identically in both
    packages, so their structural fingerprints agree across them."""
    def build(mod):
        s = mod.Input.make("in", prec=1)
        r = mod.Reduce.make("max", mod.Shift.make(s, 3), 40, stride=2)
        return mod.Reduce.make("sum", r, 10, stride=2)
    assert ir.fingerprint(build(ir)) == rir.fingerprint(build(rir))
    a = TStream.source("in").window(20).mean()
    b = TStream.source("in").window(20).mean()
    c = TStream.source("in").window(21).mean()
    assert ir.fingerprint(a.node) == ir.fingerprint(b.node)
    assert ir.fingerprint(a.node) != ir.fingerprint(c.node)


@pytest.mark.parametrize("op", sorted(reduction.REDUCTIONS))
@pytest.mark.parametrize("kind", ["float", "integer"])
def test_reduction_pre_post_match_reference(op, kind):
    rng = np.random.default_rng(11)
    if kind == "float":
        x = rng.normal(2.0, 3.0, 200).astype(np.float32)
    else:
        x = rng.integers(-9, 10, 200).astype(np.float32)
    red, rred = reduction.get_reduction(op), rreduction.get_reduction(op)
    assert (red.kind, red.name, red.empty_valid) == (
        rred.kind, rred.name, rred.empty_valid)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if red.pre is not None:
        got = [c.numpy() for c in red.pre(xt)]
        want = [np.asarray(c) for c in rred.pre(xj)]
        for g, w in zip(got, want):
            assert np.array_equal(g, w)      # pre is exact elementwise math
    if red.kind == "assoc":
        assert float(red.identity) == float(rred.identity)
        a, b = x[:100], x[100:]
        assert np.array_equal(
            red.combine(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(rred.combine(jnp.asarray(a), jnp.asarray(b))))
        return
    # post on window sums of each channel and a count that includes 0
    chans = [np.asarray(c) for c in rred.pre(xj)]
    sums = [np.cumsum(c.reshape(20, 10), axis=1)[:, -1].astype(np.float32)
            for c in chans]
    n = np.arange(20, dtype=np.float32) % 11
    got = red.post(tuple(torch.from_numpy(s) for s in sums),
                   torch.from_numpy(n)).numpy()
    want = np.asarray(rred.post(tuple(jnp.asarray(s) for s in sums),
                                jnp.asarray(n)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_align_index_tensors_are_built_once_per_device():
    """AlignSpec keeps the tensors it builds from its index maps: a second
    application reuses them instead of building them again."""
    # the output grid reads past both ends of the argument grid: φ there
    spec = plan.AlignSpec(plan.GridPlan(t0=-8, length=40, prec=2),
                          plan.GridPlan(t0=-20, length=35, prec=3))
    assert not spec.exact
    x = torch.arange(40, dtype=torch.float32)
    ok = torch.ones(40, dtype=torch.bool)
    v1, m1 = spec.apply(x, ok)
    built = dict(spec._tensors)
    v2, m2 = spec.apply(x + 1, ok)
    assert built and all(spec._tensors[k] is t for k, t in built.items())
    assert torch.equal(v2, v1 + 1) and torch.equal(m1, m2)
    rspec = rplan.AlignSpec(rplan.GridPlan(t0=-8, length=40, prec=2),
                            rplan.GridPlan(t0=-20, length=35, prec=3))
    rv, rm = rspec.apply(jnp.arange(40, dtype=jnp.float32),
                         jnp.ones(40, bool))
    assert np.array_equal(v1.numpy(), np.asarray(rv))
    assert np.array_equal(m1.numpy(), np.asarray(rm))
    assert not m1[0] and not m1[-1] and m1.any()


def _arrays(d):
    """Flatten a generator's output into {path: array}."""
    out = {}
    for name, v in d.items():
        for field, a in v.items():
            if isinstance(a, dict):
                out.update({(name, field, k): x for k, x in a.items()})
            else:
                out[(name, field)] = a
    return out


@pytest.mark.parametrize("name", APP_NAMES)
def test_app_generators_match_reference(name):
    """The port keeps the reference's numpy generators: the same seed gives
    the same arrays, single-stream and keyed."""
    got = _arrays(apps.make_app(name).make_input(500, 9))
    want = _arrays(rapps.make_app(name).make_input(500, 9))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    if name in apps.KEYED_APPS:
        got = _arrays(apps.make_keyed_app(name).make_keyed_input(3, 64, 9))
        want = _arrays(rapps.make_keyed_app(name).make_keyed_input(3, 64, 9))
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# the exact Reduce demand: the body evaluates only the ticks windows read
# ---------------------------------------------------------------------------

def _stride5(S, keyed):
    """A prec-5 sum over 10 ticks read by a prec-1 join 3 ticks back: the
    sum's demand, 3 + 5, is no multiple of its stride."""
    s = S.source("in", prec=1, keyed=keyed)
    x = s.window(10, stride=5).sum()
    return s.join(x, lambda a, b: a + b).shift(3)


def _exact_case(name, keyed):
    """The port's query, the reference's, the tolerance's name (None:
    integer data, compared bit for bit) and ``make(K, T)``."""
    if name == "stride5":
        def make(K, T):
            rng = np.random.default_rng(5)
            sh = (K, T) if keyed else (T,)
            return {"in": {"value": rng.integers(-9, 10, sh).astype(float),
                           "valid": rng.random(sh) > 0.2}}
        return (_stride5(TStream, keyed).node,
                _stride5(RTStream, keyed).node, None, make)
    if keyed:
        app, rapp = apps.make_keyed_app(name), rapps.make_keyed_app(name)
        return (app.query.node, rapp.query.node, name,
                lambda K, T: app.make_keyed_input(K, T, 7))
    app, rapp = apps.make_app(name), rapps.make_app(name)
    return (app.query.node, rapp.query.node, name,
            lambda K, T: app.make_input(T, 7))


def _rgrids(data, t0=0):
    out = {}
    for name, d in data.items():
        v = d["value"]
        v = ({k: jnp.asarray(a, jnp.float32) for k, a in v.items()}
             if isinstance(v, dict) else jnp.asarray(v, jnp.float32))
        out[name] = rstream.SnapshotGrid(value=v, valid=jnp.asarray(d["valid"]),
                                         t0=t0, prec=1)
    return out


def _leaves(v):
    if isinstance(v, dict):
        return {k: np.asarray(a) for k, a in v.items()}
    return {"v": np.asarray(v)}


def _chunk(data, lo, hi):
    return {n: {"value": ({k: a[..., lo:hi] for k, a in d["value"].items()}
                          if isinstance(d["value"], dict)
                          else d["value"][..., lo:hi]),
                "valid": d["valid"][..., lo:hi]} for n, d in data.items()}


def _assert_reduce_args_exact(p):
    """Each Reduce's argument grid begins at the first tick the Reduce's
    earliest output reads (at 0 where that lies past 0), or earlier only
    where another consumer, not a Reduce, reads further back."""
    order = ir.topo_order(p.root)
    readers = {}
    for n in order:
        for a in n.args:
            readers.setdefault(id(a), []).append(n)

    def first(r):          # the earliest output reads (first, ...]
        return min(p.plan_of(r).t0 + r.prec - r.window, 0)

    for n in order:
        if not isinstance(n, ir.Reduce):
            continue
        (a,) = n.args
        t0 = p.plan_of(a).t0
        assert t0 <= first(n)
        if all(isinstance(r, ir.Reduce) for r in readers[id(a)]):
            assert t0 == min(first(r) for r in readers[id(a)])


EXACT_CASES = ([(n, False) for n in APP_NAMES]
               + [(n, True) for n in sorted(apps.KEYED_APPS)]
               + [("stride5", False), ("stride5", True)])


@pytest.mark.parametrize("name,keyed", EXACT_CASES)
@pytest.mark.parametrize("out_len", [1, 64, 1000])
def test_exact_reduce_demand(name, keyed, out_len):
    """(a) Reduce arguments begin at the ticks their windows read; (b) the
    one-shot path equals the reference's (its one-shot path, or its runner
    where keyed) within the app's tolerance, integer data bit for bit, and
    the Runner's dense and sparse bodies (3 chunks; lookback-only queries)
    equal the one-shot path bit for bit, validity equal."""
    q, rq, tol, make = _exact_case(name, keyed)
    exe = qc.compile_query(q, out_len, sparse=True)
    _assert_reduce_args_exact(exe.plan)
    span = out_len * exe.out_prec
    spc = max(1, 8 // span)                  # segments a chunk
    n_parts, K = 3 * spc, 3
    data = make(K, n_parts * span)
    got = par.partition_run(exe, apps.make_grids(data, device="cpu"), 0,
                            n_parts)
    rexe = rqc.compile_query(rq, out_len, pallas=False)
    step = spc * span
    if keyed:     # the reference's keyed path is its runner, chunk by chunk
        rr = RRunner(rexe, RPolicy(keys="vmapped"), n_keys=K,
                     segs_per_chunk=spc)
        parts = [rr.step(_rgrids(_chunk(data, c * step, (c + 1) * step),
                                 t0=c * step)) for c in range(3)]
        want_valid = np.concatenate([np.asarray(g.valid) for g in parts], -1)
        wv = {k: np.concatenate([_leaves(g.value)[k] for g in parts], -1)
              for k in _leaves(parts[0].value)}
    else:
        want = rpar.partition_run(rexe, _rgrids(data), 0, n_parts)
        want_valid, wv = np.asarray(want.valid), _leaves(want.value)
    gv = _leaves(got.value)
    if tol is None:
        assert np.array_equal(got.valid.numpy(), want_valid)
        m = got.valid.numpy()
        assert all(np.array_equal(gv[k][m], wv[k][m]) for k in wv)
    else:
        tolerance.compare(tol, got.valid.numpy(), gv, want_valid, wv)
    if any(s.right_halo for s in exe.input_specs.values()):
        return                                # chunked runners look back
    for body in ("dense", "sparse"):
        r = Runner(exe, ExecPolicy(body=body,
                                   keys="vmapped" if keyed else "single"),
                   n_keys=K if keyed else None, segs_per_chunk=spc)
        parts = [r.step(apps.make_grids(_chunk(data, c * step,
                                               (c + 1) * step),
                                        device="cpu", t0=c * step))
                 for c in range(3)]
        valid = torch.cat([g.valid for g in parts], -1)
        assert torch.equal(valid, got.valid), body
        for k, v in _leaves(got.value).items():
            rv = np.concatenate([_leaves(g.value)[k] for g in parts], -1)
            assert np.array_equal(rv[valid.numpy()], v[valid.numpy()]), body


@pytest.mark.parametrize("case", ["ysb", "sliding"])
def test_runner_eval_trim_pct(case):
    """The runner's gauge of the unit window the body leaves out: half for
    ysb's tumbling count (the halo a tumbling window never reads), one tick
    in ``W + core`` for a stride-1 window; set again after warm-up."""
    if case == "ysb":
        q = apps.make_keyed_app("ysb", win=10000).query.node
        exe, want = qc.compile_query(q, 1), 50.0
        r = Runner(exe, ExecPolicy(keys="vmapped"), n_keys=100,
                   segs_per_chunk=16)
    else:
        W, core = 50, 64
        q = TStream.source("in").window(W).sum().node
        exe, want = qc.compile_query(q, core), 100 / (W + core)
        r = Runner(exe, ExecPolicy())
    name = "runner.eval_trim_pct.in"
    assert r.metrics.snapshot()["gauges"][name]["value"] == want
    r.metrics.reset_after_warmup()
    assert r.metrics.snapshot()["gauges"][name]["value"] == want
