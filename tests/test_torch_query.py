"""Port query path against the reference: every app through
``compile_query`` + ``partition_run``, the keyed apps through
``batch_run``, the interpreted mode, both sum algorithms, and the data
carried across packages.

Integer-valued data must come out bit-identical (the reference's exactness
contract).  Float data is compared at identical partitioning, within a
tolerance set by what the windows hold: the two packages add the same f32
terms in another order, so each bound is a few ulps of the window's
content.  A ``> 0`` predicate whose operand lies within ``gate`` of 0 may
flip.  The limits and their reasons are in ``repro_torch.data.tolerance``,
which ``chip_smoke.py`` holds the card to as well.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as rqc
from repro.core import parallel as rpar
from repro.core.frontend import TStream as RTStream
from repro.core.stream import SnapshotGrid as RGrid
from repro.data import apps as rapps
from repro_torch import convert
from repro_torch.core import compile as qc
from repro_torch.core import parallel as par
from repro_torch.core.frontend import TStream
from repro_torch.data import apps, tolerance

N, PART = 4096, 1024
KEYS, KEY_TICKS = 16, 600


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


def _compare(name, got, want):
    tolerance.compare(name, got.valid.numpy(), _leaves(got.value),
                      np.asarray(want.valid), _leaves(want.value))


def _assert_bit_identical(got, want):
    gv, wv = _leaves(got.value), _leaves(want.value)
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    m = got.valid.numpy()
    for k in gv:
        assert gv[k].dtype == wv[k].dtype
        assert np.array_equal(gv[k][m], wv[k][m]), k


# The subtract-on-evict sum's f32 error grows with the prefix sum, i.e.
# with stream position times the mean (the reference documents it as
# unusable beyond ~1e6 ticks of O(100) values).  Its apps here are the ones
# whose prefix stays small: zero-mean signals and 0/1 counts.  The price and
# amount apps run it in test_integer_queries_bit_identical's algorithms.
APP_CASES = ([(n, "block") for n in sorted(apps.APPS)] +
             [(n, "soe") for n in ("impute", "pantomkins", "resample",
                                   "vibration", "ysb", "znorm")])


@pytest.mark.parametrize("name,algo", APP_CASES)
def test_app_partition_run_matches_reference(name, algo):
    app, rapp = apps.make_app(name), rapps.make_app(name)
    data = app.make_input(N, 3)
    exe = qc.compile_query(app.query.node, out_len=PART // app.query.prec,
                           sum_algo=algo)
    rexe = rqc.compile_query(rapp.query.node,
                             out_len=PART // rapp.query.prec, pallas=False,
                             sum_algo=algo)
    got = par.partition_run(exe, apps.make_grids(data, device="cpu"), 0,
                            N // PART)
    want = rpar.partition_run(rexe, _ref_grids(data), 0, N // PART)
    _compare(name, got, want)


@pytest.mark.parametrize("name", sorted(apps.KEYED_APPS))
def test_keyed_app_batch_run_matches_reference(name):
    app, rapp = apps.make_keyed_app(name), rapps.make_keyed_app(name)
    data = app.make_keyed_input(KEYS, KEY_TICKS, 7)
    exe = qc.compile_query(app.query.node,
                           out_len=KEY_TICKS // app.query.prec)
    rexe = rqc.compile_query(rapp.query.node,
                             out_len=KEY_TICKS // rapp.query.prec,
                             pallas=False)
    got = par.batch_run(exe, apps.make_grids(data, device="cpu"))
    want = rpar.batch_run(rexe, _ref_grids(data))
    assert got.valid.shape == (KEYS, exe.out_len)
    _compare(name, got, want)
    # each key equals its own single-stream run
    one = {n: {"value": ({k: a[3] for k, a in d["value"].items()}
                         if isinstance(d["value"], dict) else d["value"][3]),
               "valid": d["valid"][3]} for n, d in data.items()}
    single = par.batch_run(exe, apps.make_grids(one, device="cpu"))
    for k, v in _leaves(single.value).items():
        assert np.array_equal(v, _leaves(got.value)[k][3])


def _int_queries(T):
    """Queries whose outputs stay integer-valued on small-integer inputs:
    sums, counts, max/min/absmax windows (strided too), shifts, joins,
    gates and hold-interpolation."""
    def build(S):
        s = S.source("a", prec=1)
        b = S.source("b", prec=2)
        return {
            "sum_where": s.window(37).sum().where(lambda v: v > 0),
            "count_stride": s.window(10, stride=5).count(),
            "max_shift": s.window(64).max().shift(3),
            "min_small": s.window(5).min(),
            "absmax_stride": s.window(12, stride=4).absmax(),
            "sum_small": s.window(3).sum(),
            "join_mixed_prec": s.join(b.window(8, stride=2).sum(),
                                      lambda x, y: x + y),
            "hold": s.interpolate(mode="hold", max_gap=4),
            "wide": s.window(2 * T).sum(),
        }
    return build(RTStream), build(TStream)


def _int_data(T, seed=1):
    rng = np.random.default_rng(seed)
    return {"a": {"value": rng.integers(-20, 21, T).astype(np.float64),
                  "valid": rng.random(T) > 0.2},
            "b": {"value": rng.integers(0, 9, T // 2).astype(np.float64),
                  "valid": rng.random(T // 2) > 0.3}}


def _grids_prec(data, mk):
    out = {}
    for name, d in data.items():
        p = 2 if name == "b" else 1
        out[name] = mk({name: d}, p)[name]
    return out


@pytest.mark.parametrize("qname", sorted(_int_queries(512)[1]))
@pytest.mark.parametrize("algo", ["block", "soe"])
def test_integer_queries_bit_identical(qname, algo):
    T, part = 512, 128
    rq, q = (d[qname] for d in _int_queries(T))
    data = _int_data(T)
    exe = qc.compile_query(q.node, out_len=part // q.prec, sum_algo=algo)
    got = par.partition_run(
        exe, _grids_prec(data, lambda d, p: apps.make_grids(
            d, device="cpu", prec=p)), 0, T // part)
    # the reference through its plain path, and through its Pallas
    # kernels in interpret mode for the block sum (its soe path's Pallas
    # scan is held in test_torch_kernels.py)
    for pallas in (False, True) if algo == "block" else (False,):
        rexe = rqc.compile_query(rq.node, out_len=part // rq.prec,
                                 pallas=pallas, sum_algo=algo)
        want = rpar.partition_run(
            rexe, _grids_prec(data, lambda d, p: {
                n: RGrid(value=jnp.asarray(v["value"], jnp.float32),
                         valid=jnp.asarray(v["valid"]), t0=0, prec=p)
                for n, v in d.items()}), 0, T // part)
        _assert_bit_identical(got, want)


@pytest.mark.parametrize("name", ["trend", "znorm", "vibration"])
def test_interpreted_equals_fused(name):
    """Operator-at-a-time evaluation runs the same node evaluator, so it
    reproduces the fused result bit for bit, with or without fusion."""
    app = apps.make_app(name)
    grids = apps.make_grids(app.make_input(2048, 5), device="cpu")
    for opt in (True, False):
        exe = qc.compile_query(app.query.node, out_len=512 // app.query.prec,
                               opt=opt)
        fused = par.partition_run(exe, grids, 0, 4)
        interp = par.partition_run(exe, grids, 0, 4, interpreted=True)
        assert torch.equal(fused.valid, interp.valid)
        for k, v in _leaves(fused.value).items():
            assert np.array_equal(v, _leaves(interp.value)[k])
    # run_interpreted called directly on the first partition's inputs
    spec = exe.input_specs["in"]
    g = par.slice_grid(grids["in"], spec.t0, spec.t0 + spec.length)
    out = exe.run_interpreted({"in": (g.value, g.valid)})
    assert torch.equal(out[1], fused.valid[:exe.out_len])


def test_generic_reduction_matches_reference():
    """A custom reduction given by the paper's Init/Acc/Result template
    runs the generic path (plain torch, no kernel) in both packages."""
    from repro.core.reduction import Reduction as RReduction
    from repro_torch.core.reduction import Reduction
    rq = RTStream.source("a").window(9, stride=3).reduce(RReduction(
        name="gsum", kind="generic", init=lambda: 0.0,
        acc=lambda s, v: s + v, result=lambda s: s))
    q = TStream.source("a").window(9, stride=3).reduce(Reduction(
        name="gsum", kind="generic", init=lambda: 0.0,
        acc=lambda s, v: s + v, result=lambda s: s))
    data = {"a": _int_data(240)["a"]}
    got = par.partition_run(qc.compile_query(q.node, out_len=20),
                            apps.make_grids(data, device="cpu"), 0, 4)
    want = rpar.partition_run(
        rqc.compile_query(rq.node, out_len=20, pallas=False),
        _ref_grids(data), 0, 4)
    _assert_bit_identical(got, want)


def test_run_interpreted_matches_reference_interpreted():
    rq, q = (d["max_shift"] for d in _int_queries(256))
    data = _int_data(256)
    exe = qc.compile_query(q.node, out_len=64, opt=False)
    rexe = rqc.compile_query(rq.node, out_len=64, opt=False, pallas=False)
    got = par.partition_run(exe, apps.make_grids(
        {"a": data["a"]}, device="cpu"), 0, 4, interpreted=True)
    want = rpar.partition_run(rexe, _ref_grids({"a": data["a"]}), 0, 4,
                              interpreted=True)
    _assert_bit_identical(got, want)


def test_slice_grid_matches_reference():
    data = _int_data(64)["a"]
    g = apps.make_grids({"a": data}, device="cpu")["a"]
    rg = _ref_grids({"a": data})["a"]
    for t0, t_end in ((-8, 20), (10, 30), (50, 80)):
        got = par.slice_grid(g, t0, t_end)
        want = rpar.slice_grid(rg, t0, t_end)
        assert np.array_equal(got.value.numpy(), np.asarray(want.value))
        assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    with pytest.raises(ValueError):
        par.slice_grid(apps.make_grids({"a": data}, device="cpu",
                                       prec=2)["a"], 1, 9)


@pytest.mark.parametrize("keyed", [False, True])
def test_convert_round_trips_reference_grids(keyed):
    """A reference grid's arrays become a port grid (copied, dtypes kept,
    no read-only warning) and come back unchanged."""
    app = rapps.make_keyed_app("ysb") if keyed else rapps.make_app("ysb")
    data = (app.make_keyed_input(4, 50, 2) if keyed
            else app.make_input(50, 2))
    rg = _ref_grids(data)["in"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g = convert.to_grid(rg.value, rg.valid, rg.t0, rg.prec,
                            device="cpu")
    assert g.valid.dtype == torch.bool and g.value["etype"].dtype == (
        torch.float32)
    g.value["camp"][..., 0] = -1.0      # a copy: the source is untouched
    assert float(np.asarray(rg.value["camp"])[..., 0].min()) >= 0
    value, valid, t0, prec = convert.to_numpy(g)
    assert (t0, prec) == (rg.t0, rg.prec)
    assert np.array_equal(valid, np.asarray(rg.valid))
    assert np.array_equal(value["etype"], np.asarray(rg.value["etype"]))
