"""The port's change-compressed execution (``repro_torch.core.sparse``)
against its dense path and against the reference, as
``tests/test_sparse.py`` holds the reference (its mesh cases wait for the
multi-device slice).

The invariant is the reference's: sparse ≡ dense **bit for bit** on
integer-valued data at the same partitioning, whatever the change pattern
— the all-clean and all-dirty extremes, dirty spans that cross partition
boundaries, strided outputs, lookahead at the grid's end, explicit
change-event channels.  The port's ``partition_run`` is bit-identical to
the reference's on such data (``tests/test_torch_query.py``); here the
port's ``sparse_run`` is held to the port's ``partition_run`` for the whole
query zoo, and to the reference's ``sparse_run`` and ``segment_mask``
directly.  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile as rqc
from repro.core import sparse as rsp
from repro.core.frontend import TStream as RTStream
from repro.core.stream import SnapshotGrid as RGrid
from repro_torch.core import compile as qc
from repro_torch.core import sparse as sp
from repro_torch.core.frontend import TStream
from repro_torch.core.parallel import partition_run
from repro_torch.core.stream import SnapshotGrid

N = 512


def pw_const(n, rate, seed, invalid_spans=()):
    rng = np.random.default_rng(seed)
    change = rng.random(n) < rate
    change[0] = True
    raw = np.floor(rng.random(n) * 100).astype(np.float32)
    idx = np.maximum.accumulate(np.where(change, np.arange(n), -1))
    vals = raw[idx]
    valid = np.ones(n, bool)
    for a, b in invalid_spans:
        valid[a:b] = False
    return vals, valid


def _grid(vals, valid, t0=0):
    return {"in": SnapshotGrid(value=torch.from_numpy(vals.copy()),
                               valid=torch.from_numpy(valid.copy()),
                               t0=t0, prec=1)}


def _rgrid(vals, valid):
    return {"in": RGrid(value=jnp.asarray(vals), valid=jnp.asarray(valid),
                        t0=0, prec=1)}


def _assert_same(ref, got, ctx=""):
    m1, m2 = np.asarray(ref.valid), np.asarray(got.valid)
    assert np.array_equal(m1, m2), (ctx, m1.sum(), m2.sum())
    assert np.array_equal(np.asarray(ref.value)[m1],
                          np.asarray(got.value)[m1]), ctx


def _trend(s):
    return (s.window(16).mean()
            .join(s.window(32).mean(), lambda a, b: a - b)
            .where(lambda d: d > 0))


QUERIES = {
    "trend": (_trend, 32),
    "tumbling": (lambda s: s.window(8, stride=8).sum(), 8),
    "shifted": (lambda s: s.join(s.shift(3), lambda a, b: a - b), 32),
    "coalesce_const": (lambda s: s.coalesce(type(s).const(5.0)), 32),
    "interp": (lambda s: s.interpolate(mode="linear", max_gap=8), 32),
}


def _exe(name, sparse=True):
    fn, out_len = QUERIES[name]
    q = fn(TStream.source("in", prec=1))
    exe = qc.compile_query(q.node, out_len=out_len, sparse=sparse)
    return exe, N // (out_len * exe.out_prec)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_sparse_run_bit_identical_to_partition_run(name):
    exe, n_parts = _exe(name)
    vals = np.full(N, 6.0, np.float32)
    vals[77] = 13.0
    vals[78:] = 2.0
    vals[305:] = 9.0
    valid = np.ones(N, bool)
    valid[100:130] = False
    g = _grid(vals, valid)
    ref = partition_run(exe, g, 0, n_parts)
    for fused in (True, False):
        _assert_same(ref, sp.sparse_run(exe, g, 0, n_parts, fused=fused),
                     (name, fused))
    n_dirty = int(sp.segment_mask(exe, g, 0, n_parts).sum())
    assert n_dirty < n_parts, (name, n_dirty, n_parts)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_fused_and_three_phase_and_masks_agree(name):
    """Fused (kernel mask, full-capacity dense body) ≡ three-phase (staged
    mask, compacted step at every bucket), at a compacting rate and at the
    all-dirty extreme; the kernel mask ≡ the staged mask ≡ the reference's
    staged mask."""
    fn, out_len = QUERIES[name]
    exe, n_parts = _exe(name)
    rexe = rqc.compile_query(fn(RTStream.source("in", prec=1)).node,
                             out_len=out_len, pallas=False, sparse=True)
    for rate, seed in ((0.02, 3), (1.0, 5)):
        vals, valid = pw_const(N, rate, seed, invalid_spans=((40, 70),))
        g = _grid(vals, valid)
        _assert_same(sp.sparse_run(exe, g, 0, n_parts, fused=False),
                     sp.sparse_run(exe, g, 0, n_parts, fused=True),
                     (name, rate))
        staged = sp.segment_mask(exe, g, 0, n_parts).numpy()
        kernel = sp.segment_mask(exe, g, 0, n_parts, kernel=True).numpy()
        want = np.asarray(rsp.segment_mask(rexe, _rgrid(vals, valid), 0,
                                           n_parts))
        assert np.array_equal(staged, kernel), (name, rate)
        assert np.array_equal(staged, want), (name, rate)


def test_sparse_run_bit_identical_to_reference_sparse_run():
    q, rq = (_trend(TStream.source("in", prec=1)),
             _trend(RTStream.source("in", prec=1)))
    exe = qc.compile_query(q.node, out_len=32, sparse=True)
    rexe = rqc.compile_query(rq.node, out_len=32, pallas=False, sparse=True)
    vals, valid = pw_const(N, 0.03, 21, invalid_spans=((200, 230),))
    got = sp.sparse_run(exe, _grid(vals, valid), 0, N // 32)
    want = rsp.sparse_run(rexe, _rgrid(vals, valid), 0, N // 32,
                          fused=False)
    _assert_same(want, got)


def test_strided_output_dilation_covers_stride_gap():
    exe, n_parts = _exe("tumbling")
    for pos in (57, 60, 63, 64):
        vals = np.full(N, 3.0, np.float32)
        vals[pos:] = 8.0
        g = _grid(vals, np.ones(N, bool))
        _assert_same(partition_run(exe, g, 0, n_parts),
                     sp.sparse_run(exe, g, 0, n_parts), f"pos={pos}")


def test_lookahead_grid_end_is_a_virtual_change():
    q = TStream.source("in", prec=1).shift(-5)
    exe = qc.compile_query(q.node, out_len=32, sparse=True)
    g = _grid(np.full(256, 3.0, np.float32), np.ones(256, bool))
    ref = partition_run(exe, g, 0, 8)
    assert not ref.valid[-5:].any()
    _assert_same(ref, sp.sparse_run(exe, g, 0, 8), "grid-end")


def test_sparse_all_clean_and_all_dirty_extremes():
    exe, n_parts = _exe("trend")
    g = _grid(np.full(N, 7.0, np.float32), np.ones(N, bool))
    mask = sp.segment_mask(exe, g, 0, n_parts).numpy()
    assert mask[0] and not mask[2:].any(), mask.astype(int)
    _assert_same(partition_run(exe, g, 0, n_parts),
                 sp.sparse_run(exe, g, 0, n_parts), "all-clean")
    vals, valid = pw_const(N, 1.0, seed=5)
    g = _grid(vals, valid)
    assert sp.segment_mask(exe, g, 0, n_parts).all()
    _assert_same(partition_run(exe, g, 0, n_parts),
                 sp.sparse_run(exe, g, 0, n_parts), "all-dirty")


def test_dirty_span_crosses_partition_boundary():
    exe, n_parts = _exe("trend")
    vals = np.full(N, 4.0, np.float32)
    vals[95:] = 9.0
    g = _grid(vals, np.ones(N, bool))
    mask = sp.segment_mask(exe, g, 0, n_parts).numpy()
    assert mask[2] and mask[3] and not mask[4:].any(), mask.astype(int)
    _assert_same(partition_run(exe, g, 0, n_parts),
                 sp.sparse_run(exe, g, 0, n_parts), "boundary")


def test_explicit_change_channel_overrides_diff():
    exe, n_parts = _exe("trend")
    rng = np.random.default_rng(9)
    change = rng.random(N) < 0.02
    change[0] = True
    raw = np.floor(rng.random(N) * 100).astype(np.float32)
    vals = raw[np.maximum.accumulate(np.where(change, np.arange(N), -1))]
    g = _grid(vals, np.ones(N, bool))
    ref = partition_run(exe, g, 0, n_parts)
    for d in (torch.from_numpy(change), torch.ones(N, dtype=torch.bool)):
        for fused in (True, False):
            _assert_same(ref, sp.sparse_run(exe, g, 0, n_parts,
                                            dirty={"in": d}, fused=fused),
                         "explicit")
    assert sp.segment_mask(exe, g, 0, n_parts,
                           dirty={"in": torch.ones(N, dtype=torch.bool)}
                           ).all()


def test_sparse_run_requires_sparse_compile():
    exe, n_parts = _exe("trend", sparse=False)
    with pytest.raises(ValueError, match="sparse=True"):
        sp.sparse_run(exe, _grid(np.zeros(N, np.float32),
                                 np.ones(N, bool)), 0, n_parts)


def test_bucket_policy_and_fixed_size_ids():
    for n, cap in ((0, 1), (1, 1), (3, 4), (9, 16), (100, 16)):
        assert sp.bucket_capacity(n, 16) == cap == rsp.bucket_capacity(n, 16)
    for n in (1, 5, 16, 17):
        assert sp.capacity_ladder(n) == rsp.capacity_ladder(n)
    w = torch.tensor([0, 1, 0, 0, 1, 1, 0, 1], dtype=torch.bool)
    for size in (4, 8):
        ids, pos = sp.compact_ids(w, size)
        assert ids.tolist() == np.asarray(jnp.nonzero(
            jnp.asarray(w.numpy()), size=size, fill_value=0)[0]).tolist()
        assert pos.tolist() == np.clip(np.cumsum(w.numpy()) - 1, 0,
                                       size - 1).tolist()


def test_planning_arithmetic_matches_reference():
    args = (33, 0, 1, -33, 0, 1, 32, 6)
    for a, b in zip(sp.seg_ranges(*args), rsp.seg_ranges(*args)):
        assert np.array_equal(a, b)
    rargs = (33, 2, 1, 64, 1, 32, 4, [70, 150, 1000])
    assert np.array_equal(sp.retro_segment_mask(*rargs),
                          rsp.retro_segment_mask(*rargs))
    i_lo, i_hi1 = sp.seg_ranges(*args)
    aff = (i_lo[0], 32, int(i_hi1[0] - i_lo[0]))
    assert np.array_equal(sp.affine_covers(aff, i_lo, i_hi1),
                          rsp.affine_covers(aff, i_lo, i_hi1))
    d = np.random.default_rng(1).random(200) < 0.05
    lo, hi = np.arange(0, 200, 25) - 3, np.arange(0, 200, 25) + 30
    assert np.array_equal(sp.range_any(torch.from_numpy(d), lo, hi).numpy(),
                          np.asarray(rsp.range_any(jnp.asarray(d),
                                                   jnp.asarray(lo),
                                                   jnp.asarray(hi))))


def test_sparse_run_reports_into_the_default_registry():
    from repro_torch import obs
    exe, n_parts = _exe("trend")
    vals, valid = pw_const(N, 0.02, 4)
    reg = obs.default()
    s0 = reg.snapshot()
    sp.sparse_run(exe, _grid(vals, valid), 0, n_parts)
    s1 = reg.snapshot()
    assert obs.counter_delta(s0, s1, "sparse.runs") == 1
    assert obs.counter_delta(s0, s1, "sparse.segments") == n_parts
    dirty = obs.counter_delta(s0, s1, "sparse.dirty_segments")
    assert 0 < dirty < n_parts
    assert any(k.startswith("sparse_run(") for k in s1["compiles"]["counts"])


def test_random_change_masks_never_alter_outputs():
    """Property: for any change pattern (and any φ gaps), sparse ≡ dense."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    n = 128
    exe = qc.compile_query(_trend(TStream.source("in", prec=1)).node,
                           out_len=16, sparse=True)

    @settings(max_examples=25, deadline=None)
    @given(st.integers(0, 2 ** 31 - 1), st.floats(0.0, 1.0),
           st.floats(0.0, 0.3))
    def prop(seed, rate, invalid_rate):
        rng = np.random.default_rng(seed)
        change = rng.random(n) < rate
        change[0] = True
        raw = np.floor(rng.random(n) * 100).astype(np.float32)
        vals = raw[np.maximum.accumulate(
            np.where(change, np.arange(n), -1))]
        valid = rng.random(n) >= invalid_rate
        g = _grid(vals, valid)
        _assert_same(partition_run(exe, g, 0, n // 16),
                     sp.sparse_run(exe, g, 0, n // 16), f"seed={seed}")

    prop()
