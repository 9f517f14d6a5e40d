"""The port's EventSPE baseline and the rest of its ``data/apps.py``
against the reference.

* The port's EventSPE (a copy of ``repro.spe.eventspe``) runs every app's
  and every temporal op's ``spe`` pipeline on the same numpy batches as the
  reference's: the outputs are equal exactly (both are the same numpy
  code).
* The port's TiLT against the port's EventSPE, for the nine apps and the
  four temporal ops, as ``tests/test_apps_equivalence.py`` holds the
  reference: N=3000, BATCH=500, the same ``REL_TOL`` and ``MARGIN``.
* ``dashboard_queries`` through ``partition_run`` (keyed: ``batch_run``)
  in both packages, at identical partitioning.  On integer prices in
  [0, 16) every window sum is exact: the trend heads, which read the means
  only, are bit-identical.  The breakout and momentum heads read the
  stddev's E[x^2] - E[x]^2, which XLA contracts into a fused multiply-add
  and the port does not, so they differ by an ulp or two of E[x^2]
  (``STD_ATOL``; a breakout may flip only within it of 0).  On the
  dashboard's own random walks around 100 the packages add the same f32
  terms in another order: the trend heads agree to a few ulps of 100
  (``DASH_ATOL``, ``DASH_RTOL``) and may flip only where their difference
  lies within ``DASH_GATE`` of the threshold.  There the stddev heads are
  not compared: the long window's variance is near 1e-2 under values near
  100, so an ulp of 1e4 in E[x^2] moves it by tens of percent in either
  package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as rqc
from repro.core import parallel as rpar
from repro.core.stream import SnapshotGrid as RGrid
from repro.data import apps as RA
from repro.spe import eventspe as res
from repro_torch.core import compile as qc
from repro_torch.core.parallel import batch_run, partition_run
from repro_torch.data import apps as A
from repro_torch.spe import eventspe as es

N = 3000
BATCH = 500
REL_TOL = 2e-3          # value agreement
MARGIN = 1e-2           # |predicate operand| below this → flip excused
DASH_N, DASH_PART = 4096, 1024
DASH_ATOL, DASH_RTOL, DASH_GATE = 1e-3, 1e-3, 1e-3
STD_ATOL = 1e-5


def _batches(data, mod):
    for i in range(0, N, BATCH):
        sl = slice(i, i + BATCH)
        env = {}
        for nm, dd in data.items():
            v = dd["value"]
            v = ({k: a[sl] for k, a in v.items()} if isinstance(v, dict)
                 else v[sl])
            env[nm] = mod.Batch(dd["ts"][sl], v, dd["valid"][sl])
        yield env


def _vals(v, i):
    if isinstance(v, dict):
        return {k: float(np.asarray(a)[i]) for k, a in v.items()}
    return float(np.asarray(v)[i])


def _apps():
    return ([("app", n) for n in sorted(RA.APPS)]
            + [("op", n) for n in A.TEMPORAL_OPS])


def _make(kind, name, pkg):
    return pkg.make_app(name) if kind == "app" else pkg.temporal_op(name)


# ---------------------------------------------------------------------------
# the port's EventSPE against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,name", _apps())
def test_eventspe_matches_reference(kind, name):
    app, rapp = _make(kind, name, A), _make(kind, name, RA)
    data = app.make_input(N, 42)
    got = app.spe.run(_batches(data, es))
    want = rapp.spe.run(_batches(rapp.make_input(N, 42), res))
    assert len(got) == len(want) >= N // BATCH
    for g, w in zip(got, want):
        assert np.array_equal(g.ts, w.ts)
        assert np.array_equal(g.valid, w.valid)
        gv = g.value if isinstance(g.value, dict) else {"v": g.value}
        wv = w.value if isinstance(w.value, dict) else {"v": w.value}
        assert gv.keys() == wv.keys()
        for k in gv:
            assert np.array_equal(np.asarray(gv[k]), np.asarray(wv[k]),
                                  equal_nan=True), (name, k)


def test_eventspe_operators_are_the_reference_copy():
    assert sorted(es.__all__) == sorted(res.__all__)
    w = es.WindowAgg("mean", 4)
    rw = res.WindowAgg("mean", 4)
    x = np.arange(10, dtype=np.float64)
    b = es.Batch(np.arange(1, 11), x, np.ones(10, bool))
    rb = res.Batch(np.arange(1, 11), x, np.ones(10, bool))
    assert np.array_equal(w(b).value, rw(rb).value)


# ---------------------------------------------------------------------------
# the port's TiLT against the port's EventSPE (test_apps_equivalence.py)
# ---------------------------------------------------------------------------

def _compare(app):
    data = app.make_input(N, 42)
    exe = qc.compile_query(app.query.node, out_len=N // app.query.prec)
    out = partition_run(exe, A.make_grids(data, device="cpu"), 0, 1)
    m = out.valid.numpy()
    value = ({k: a.numpy() for k, a in out.value.items()}
             if isinstance(out.value, dict) else out.value.numpy())
    t_ts = out.t0 + (np.arange(len(m)) + 1) * out.prec
    tilt_idx = {int(ts): i for i, ts in enumerate(t_ts)}

    spe_outs = app.spe.run(_batches(data, es))

    flips, checked, max_err = 0, 0, 0.0
    for o in spe_outs:
        for j in range(len(o.ts)):
            i = tilt_idx.get(int(o.ts[j]))
            if i is None:
                assert not o.valid[j], (f"SPE event at {o.ts[j]} outside "
                                        "TiLT domain")
                continue
            if bool(m[i]) != bool(o.valid[j]):
                # predicate-boundary flip, excused near the threshold
                tv, sv = _vals(value, i), _vals(o.value, j)
                mag = min(abs(v) for v in
                          ([sv] if not isinstance(sv, dict) else
                           list(sv.values()))
                          + ([tv] if not isinstance(tv, dict) else
                             list(tv.values())))
                if mag >= MARGIN:
                    flips += 1
                continue
            if not m[i]:
                continue
            checked += 1
            tv, sv = _vals(value, i), _vals(o.value, j)
            if isinstance(tv, dict):
                err = max(abs(tv[k] - sv[k]) / max(abs(sv[k]), 1.0)
                          for k in tv)
            else:
                err = abs(tv - sv) / max(abs(sv), 1.0)
            max_err = max(max_err, err)
    return flips, checked, max_err


@pytest.mark.parametrize("name", sorted(A.APPS))
def test_app_equivalence(name):
    flips, checked, max_err = _compare(A.make_app(name))
    assert checked > 10, f"{name}: only {checked} comparable events"
    assert flips <= max(3, checked // 200), (
        f"{name}: {flips} validity mismatches over {checked} events")
    assert max_err < REL_TOL, f"{name}: max rel err {max_err:.2e}"


@pytest.mark.parametrize("op", A.TEMPORAL_OPS)
def test_temporal_op_equivalence(op):
    flips, checked, max_err = _compare(A.temporal_op(op))
    assert checked > 10
    assert flips == 0, f"{op}: {flips} validity mismatches"
    assert max_err < 1e-5, f"{op}: max rel err {max_err:.2e}"


# ---------------------------------------------------------------------------
# the dashboard fan-out in both packages
# ---------------------------------------------------------------------------

def _ref_grid(d):
    return RGrid(value=jnp.asarray(d["value"], jnp.float32),
                 valid=jnp.asarray(d["valid"]), t0=0, prec=1)


def _dash_data(keyed, integer):
    if keyed:
        data = A.dashboard_keyed_input(8, DASH_PART, 5)
        rdata = RA.dashboard_keyed_input(8, DASH_PART, 5)
    else:
        data = A.dashboard_input(DASH_N, 5)
        rdata = RA.dashboard_input(DASH_N, 5)
    for k in ("value", "valid"):
        assert np.array_equal(data["in"][k], rdata["in"][k])
    if integer:
        rng = np.random.default_rng(3)
        data["in"]["value"] = np.floor(
            rng.random(data["in"]["value"].shape) * 16)
    return data


def _edge(i):
    """The threshold a head's operand is tested against (None: no test)."""
    return {0: 0.05 * (i // 4), 1: -0.05 * (i // 4), 2: 0.0}.get(i % 4)


def _dash_runs(keyed, data):
    """Every dashboard head over ``data`` in both packages:
    ``{name: (port valid, port value, reference valid, reference value)}``."""
    qs = A.dashboard_queries(16, keyed=keyed)
    rqs = RA.dashboard_queries(16, keyed=keyed)
    assert list(qs) == list(rqs) == [f"q{i:02d}" for i in range(16)]
    grids = A.make_grids(data, device="cpu")
    rgrids = {"in": _ref_grid(data["in"])}
    n_parts = DASH_N // DASH_PART
    out = {}
    for name in qs:
        exe = qc.compile_query(qs[name].node, out_len=DASH_PART)
        rexe = rqc.compile_query(rqs[name].node, out_len=DASH_PART,
                                 pallas=False)
        if keyed:
            got, want = batch_run(exe, grids), rpar.batch_run(rexe, rgrids)
        else:
            got = partition_run(exe, grids, 0, n_parts)
            want = rpar.partition_run(rexe, rgrids, 0, n_parts)
        out[name] = (got.valid.numpy(), got.value.numpy(),
                     np.asarray(want.valid), np.asarray(want.value))
    return out


@pytest.mark.parametrize("keyed", [False, True])
def test_dashboard_queries_bit_identical_on_integer_prices(keyed):
    for name, (gm, gv, wm, wv) in _dash_runs(
            keyed, _dash_data(keyed, integer=True)).items():
        i = int(name[1:])
        assert gm.any(), name
        if i % 4 < 2:
            assert np.array_equal(gm, wm), name
            assert np.array_equal(gv[gm], wv[wm]), name
            continue
        both = gm & wm
        assert (np.abs(gv[both] - wv[both]) <= STD_ATOL).all(), name
        flips = gm != wm
        if _edge(i) is None:
            assert not flips.any(), name
        else:
            assert (np.abs(wv[flips]) <= STD_ATOL).all(), name


@pytest.mark.parametrize("keyed", [False, True])
def test_dashboard_queries_match_reference(keyed):
    runs = _dash_runs(keyed, _dash_data(keyed, integer=False))
    for name, (gm, gv, wm, wv) in runs.items():
        i = int(name[1:])
        if i % 4 >= 2:          # stddev heads: see the module docstring
            continue
        both = gm & wm
        assert both.any(), name
        lim = DASH_ATOL + DASH_RTOL * np.abs(wv[both])
        assert (np.abs(gv[both] - wv[both]) <= lim).all(), name
        flips = gm != wm
        assert (np.abs(wv[flips] - _edge(i)) <= DASH_GATE).all(), name
