"""Property-based tests (hypothesis) of the port's invariants: the mirror
of ``tests/test_property.py``, and the port against the reference on
random queries.

* Partition invariance, on integer-valued data with integer constants
  and the operators that keep values integers (select, where, shift,
  window sum and max, join): 1 partition and n partitions give the same
  masks and the same bits (the exactness contract).  Float data is not
  held across partitionings: the reference's own test fails there (f32
  cancellation in block sums anchored at each partition's start; ROADMAP
  C7), so the port is compared with the reference at *identical*
  partitioning instead.
* Fusion invariance (``opt`` off and on), sliding sum against
  ``np.convolve`` and the shift identity, as the reference's tests.
* Port ≡ reference on random integer queries at identical partitioning,
  with window means too: identical masks; the same bits where no mean
  feeds the query, else within 1e-5 of the largest value the windows
  hold (a mean's rounding carried through later windows).
* Subnormal constants (ROADMAP C12): a user function's constant that is
  subnormal in f32 is flushed to a zero of its sign where it meets a
  float stream, as both reference backends flush it, and kept where it
  meets an integer stream, as the reference keeps it; a subnormal
  *result* is not flushed (the reference's CPU backend flushes it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.core import compile as rqc
from repro.core.frontend import TStream as RTStream
from repro.core.parallel import partition_run as r_partition_run
from repro.core.stream import SnapshotGrid as RGrid
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.core.parallel import partition_run
from repro_torch.core.stream import SnapshotGrid

MAX_EXAMPLES = 25


def _grid(vals, valid):
    return {"in": SnapshotGrid(value=torch.from_numpy(np.array(vals)),
                               valid=torch.from_numpy(np.array(valid)),
                               t0=0, prec=1)}


def _ref_grid(vals, valid):
    return {"in": RGrid(value=jnp.asarray(vals), valid=jnp.asarray(valid),
                        t0=0, prec=1)}


def _build(ts, recipe):
    """The query of ``recipe`` (a tuple of (kind, parameter)) over
    ``ts.source("in")``, in either package's frontend."""
    s = ts.source("in", prec=1)
    q = s
    for kind, p in recipe:
        if kind == "select":
            q = q.select(lambda v, c=p: v * c + 1.0)
        elif kind == "where":
            q = q.where(lambda v, t=p: v > t)
        elif kind == "shift":
            q = q.shift(p)
        elif kind == "wsum":
            q = q.window(p).sum()
        elif kind == "wmean":
            q = q.window(p).mean()
        elif kind == "wmax":
            q = q.window(p).max()
        else:  # join with a shifted copy of itself
            q = q.join(s.shift(p), lambda a, b: a - b)
    return q


@st.composite
def recipe(draw, kinds, int_consts: bool):
    steps = []
    for _ in range(draw(st.integers(1, 4))):
        kind = draw(st.sampled_from(kinds))
        if kind == "select":
            p = (float(draw(st.integers(-2, 2))) if int_consts
                 else draw(st.floats(-2, 2, allow_nan=False)))
        elif kind == "where":
            p = draw(st.floats(-1, 1, allow_nan=False))
        elif kind in ("wsum", "wmean", "wmax"):
            p = draw(st.integers(2, 24))
        elif kind == "shift":
            p = draw(st.integers(0, 7))
        else:
            p = draw(st.integers(1, 5))
        steps.append((kind, p))
    return tuple(steps)


@st.composite
def random_stream(draw, n, integer: bool = False):
    if integer:
        vals = draw(st.lists(st.integers(-100, 100), min_size=n,
                             max_size=n))
    else:
        vals = draw(st.lists(st.floats(-100, 100, allow_nan=False,
                                       width=32), min_size=n, max_size=n))
    valid = draw(st.lists(st.booleans(), min_size=n, max_size=n))
    return np.asarray(vals, np.float32), np.asarray(valid)


_INT_KINDS = ["select", "where", "shift", "wsum", "wmax", "join"]
_ALL_KINDS = _INT_KINDS + ["wmean"]


@settings(max_examples=MAX_EXAMPLES, deadline=None)
@given(r=recipe(_INT_KINDS, True), data=random_stream(96, integer=True),
       n_parts=st.sampled_from([2, 3, 4, 8]))
def test_partition_invariance_on_integer_data(r, data, n_parts):
    """paper §5.1/§6.2: partitioning at resolved boundaries is exact."""
    vals, valid = data
    q = _build(TStream, r).node
    g = _grid(vals, valid)
    full = partition_run(qc.compile_query(q, out_len=96), g, 0, 1)
    part = partition_run(qc.compile_query(q, out_len=96 // n_parts), g, 0,
                         n_parts)
    assert torch.equal(full.valid, part.valid)
    m = full.valid
    assert torch.equal(full.value[m], part.value[m])


@settings(max_examples=MAX_EXAMPLES, deadline=None)
@given(r=recipe(_ALL_KINDS, False), data=random_stream(64))
def test_fusion_invariance(r, data):
    """§5.2 IR transformations are semantics-preserving."""
    vals, valid = data
    q = _build(TStream, r).node
    g = _grid(vals, valid)
    o1 = partition_run(qc.compile_query(q, out_len=64, opt=False), g, 0, 1)
    o2 = partition_run(qc.compile_query(q, out_len=64, opt=True), g, 0, 1)
    assert torch.equal(o1.valid, o2.valid)
    m = o1.valid
    np.testing.assert_allclose(o1.value[m].numpy(), o2.value[m].numpy(),
                               rtol=1e-4, atol=1e-4)


@settings(max_examples=MAX_EXAMPLES, deadline=None)
@given(data=random_stream(128), w=st.integers(2, 32))
def test_sliding_sum_matches_convolve(data, w):
    vals, valid = data
    q = TStream.source("in").window(w).sum()
    out = partition_run(qc.compile_query(q.node, out_len=128),
                        _grid(vals, valid), 0, 1)
    masked = np.where(valid, vals.astype(np.float64), 0.0)
    want = np.convolve(masked, np.ones(w))[:128]
    cnt = np.convolve(valid.astype(np.float64), np.ones(w))[:128]
    m = out.valid.numpy()
    assert np.array_equal(m, cnt > 0)
    np.testing.assert_allclose(out.value.numpy()[m], want[m], rtol=1e-3,
                               atol=1e-3)


@settings(max_examples=MAX_EXAMPLES, deadline=None)
@given(data=random_stream(64), d=st.integers(0, 10))
def test_shift_identity(data, d):
    """shift(d) then compare against numpy roll with φ fill."""
    vals, valid = data
    q = TStream.source("in").shift(d)
    out = partition_run(qc.compile_query(q.node, out_len=64),
                        _grid(vals, valid), 0, 1)
    m = out.valid.numpy()
    assert np.array_equal(m, np.concatenate([np.zeros(d, bool), valid])[:64])
    want_v = np.concatenate([np.zeros(d, np.float32), vals])[:64]
    np.testing.assert_array_equal(out.value.numpy()[m], want_v[m])


@settings(max_examples=MAX_EXAMPLES, deadline=None)
@given(r=recipe(_ALL_KINDS, True), data=random_stream(96, integer=True),
       n_parts=st.sampled_from([1, 2, 3, 4, 8]))
def test_port_matches_reference_on_random_integer_queries(r, data, n_parts):
    vals, valid = data
    out_len = 96 // n_parts
    want = r_partition_run(
        rqc.compile_query(_build(RTStream, r).node, out_len=out_len,
                          pallas=False), _ref_grid(vals, valid), 0, n_parts)
    got = partition_run(qc.compile_query(_build(TStream, r).node,
                                         out_len=out_len),
                        _grid(vals, valid), 0, n_parts)
    wm = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), wm)
    gv, wv = got.value.numpy()[wm], np.asarray(want.value)[wm]
    if any(kind == "wmean" for kind, _ in r):
        scale = float(np.abs(wv).max()) if wv.size else 0.0
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_array_equal(gv, wv)


# ---------------------------------------------------------------------------
# subnormal constants (C12)
# ---------------------------------------------------------------------------

def _c12_data(dtype):
    vals = np.zeros(96, dtype)
    vals[:32] = 1
    vals[40] = -1
    return vals, np.ones(96, bool)


def _both(fn, vals, valid, where: bool):
    """(port, reference) output of ``where(fn)`` or ``select(fn)``."""
    outs = []
    for ts, run, grid, kw in ((TStream, partition_run, _grid, {}),
                              (RTStream, r_partition_run, _ref_grid,
                               {"pallas": False})):
        s = ts.source("in")
        q = s.where(fn) if where else s.select(fn)
        mod = qc if ts is TStream else rqc
        outs.append(run(mod.compile_query(q.node, out_len=96, **kw),
                        grid(vals, valid), 0, 1))
    return outs


@pytest.mark.parametrize("dtype,kept", [(np.float32, 32), (np.int32, 95)])
def test_subnormal_constant_keeps_the_references_ticks(dtype, kept):
    """The C12 reproducer: ``v > -1.4e-45`` over 32 ones, one -1 and 63
    zeros.  Over floats the constant is flushed to -0.0 (0 > -0 is false:
    32 ticks kept); over integers it is kept (95), in both packages."""
    vals, valid = _c12_data(dtype)
    got, want = _both(lambda v: v > -1.4e-45, vals, valid, where=True)
    assert int(got.valid.sum()) == int(np.asarray(want.valid).sum()) == kept
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_subnormal_constant_flushed_with_its_sign_and_on_0d_tensors():
    vals, valid = _c12_data(np.float32)
    got, want = _both(lambda v: v * 1e-40, vals, valid, where=False)
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
    assert not got.value.abs().max()
    got, want = _both(lambda v: v * -1e-41, vals, valid, where=False)
    np.testing.assert_array_equal(got.value.numpy().view(np.uint32),
                                  np.asarray(want.value).view(np.uint32))
    assert torch.signbit(got.value[0]) and got.value[0] == 0
    t0d = partition_run(qc.compile_query(TStream.source("in").select(
        lambda v: v + torch.tensor(3e-39)).node, out_len=96),
        _grid(vals, valid), 0, 1)
    assert t0d.value[50] == 0 and t0d.value[0] == 1
    normal = partition_run(qc.compile_query(TStream.source("in").select(
        lambda v: v + 2e-38).node, out_len=96), _grid(vals, valid), 0, 1)
    assert normal.value[50] == np.float32(2e-38)


def test_subnormal_results_are_not_flushed():
    """A user function whose constants are normal but whose result is
    subnormal: the port keeps the subnormal, the reference's CPU backend
    flushes it to 0 (the port's contract states the difference)."""
    vals, valid = _c12_data(np.float32)
    got, want = _both(lambda v: v * 1e-30 * 1e-10, vals, valid, where=False)
    assert float(got.value[0]) == pytest.approx(1e-40, rel=1e-3)
    assert float(np.asarray(want.value)[0]) == 0.0
