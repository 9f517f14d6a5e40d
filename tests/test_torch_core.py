"""Port core against the reference: grids, IR passes, boundary resolution,
planning artifacts and reductions, field by field, on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundary as rboundary
from repro.core import fusion as rfusion
from repro.core import halo as rhalo
from repro.core import ir as rir
from repro.core import plan as rplan
from repro.core import reduction as rreduction
from repro.core import stream as rstream
from repro.data import apps as rapps
from repro_torch.core import boundary, fusion, halo, ir, plan, reduction
from repro_torch.core import stream
from repro_torch.core.frontend import TStream
from repro_torch.data import apps

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
    # node grids, in topological order of the optimized DAGs
    got = [(type(n).__name__,) + tuple(
        getattr(p.plan_of(n), f) for f in ("t0", "length", "prec"))
        for n in ir.topo_order(p.root)]
    want = [(type(n).__name__,) + tuple(
        getattr(rp.plan_of(n), f) for f in ("t0", "length", "prec"))
        for n in rir.topo_order(rp.root)]
    assert got == want
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
