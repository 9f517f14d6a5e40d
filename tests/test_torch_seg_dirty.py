"""The port's change-detection kernel on the CPU (its plain version,
``repro_torch.kernels.ref.seg_dirty_fused_ref``, which the wrapper runs
for CPU tensors) against the reference's Pallas kernel in interpret mode
and its jnp oracle.  Flags are booleans: every comparison is exact.

Covers the reference kernel sweep (``tests/test_kernels.py``: 6 lineage
geometries × {f32, int32}, NaN and several matrices of mixed dtypes), a
leading key axis (the runner's ``(K, C, T)`` matrices), the value
comparison's edges (NaN is always a change, -0.0 equals 0.0), and
``grid_mats``, which keeps leaves in place instead of stacking them per
dtype but must give the reference's flags, and every dtype a grid can carry
(the kernel reads each in place on the card: ``tests/test_torch_cuda.py``
holds it to this plain version per dtype).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels import sparse_compact as rsc
from repro_torch.kernels import ref, sparse_compact as sc

SEG_DIRTY_GEOMS = [
    (256, 1, 8, 0, 32, 32),
    (256, 3, 8, -31, 32, 64),      # window runs off the left edge
    (200, 2, 4, 7, 48, 17),        # step > width: gaps between lineages
    (64, 1, 4, -5, 16, 128),       # width > T: every segment sees the end
    (512, 4, 16, 1, 32, 33),
    (96, 2, 12, -8, 8, 1),         # single-pair windows
]


def _pw_rows(C, T, seed, lead=()):
    """Piecewise-constant integer rows (~5% change rate)."""
    rng = np.random.default_rng(seed)
    shape = lead + (C, T)
    change = rng.random(shape) < 0.05
    raw = rng.integers(0, 50, size=shape)
    idx = np.maximum.accumulate(np.where(change, np.arange(T), -1), axis=-1)
    return np.take_along_axis(raw, np.clip(idx, 0, None), axis=-1)


def _port(mats, geoms, n_segs):
    return sc.seg_dirty([torch.from_numpy(np.array(m)) for m in mats],
                        geoms, n_segs).numpy()


@pytest.mark.parametrize("T,C,n_segs,a0,step,width", SEG_DIRTY_GEOMS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_plain_seg_dirty_matches_reference_kernel(T, C, n_segs, a0, step,
                                                  width, dtype):
    x = _pw_rows(C, T, T * 31 + n_segs).astype(dtype)
    geoms = [(a0, step, width)]
    got = _port([x], geoms, n_segs)
    pallas = np.asarray(rsc.seg_dirty([jnp.asarray(x)], geoms, n_segs,
                                      pallas=True))
    oracle = np.asarray(rref.seg_dirty_fused_ref([jnp.asarray(x)], geoms,
                                                 n_segs))
    assert got.dtype == bool and got.shape == (n_segs,)
    assert np.array_equal(got, pallas) and np.array_equal(got, oracle)


def test_multiple_matrices_and_nan():
    T, n_segs = 128, 4
    a = np.zeros((1, T), np.float32)
    a[0, 60] = np.nan                      # NaN tick: always dirty
    b = np.zeros((2, T), np.int32)
    b[1, 100:] = 7                         # int change in the last segment
    geoms = [(0, 32, 32), (0, 32, 32)]
    got = _port([a, b], geoms, n_segs)
    want = np.asarray(rsc.seg_dirty([jnp.asarray(a), jnp.asarray(b)], geoms,
                                    n_segs, pallas=True))
    assert np.array_equal(got, want)
    assert list(got) == [False, True, False, True]


def test_value_comparison_edges():
    """-0.0 after 0.0 is no change; a NaN run changes at every tick
    (NaN != NaN); a bool row compares as 0/1."""
    T, n_segs = 64, 4
    a = np.zeros((1, T), np.float32)
    a[0, 10:20] = -0.0                     # segment 0: clean
    a[0, 40:44] = np.nan                   # segment 2: dirty
    m = np.ones((1, T), bool)
    m[0, 56:] = False                      # segment 3: validity flips
    geoms = [(0, 16, 16)] * 2
    got = _port([a, m], geoms, n_segs)
    want = np.asarray(rref.seg_dirty_fused_ref(
        [jnp.asarray(a), jnp.asarray(m).astype(jnp.int32)], geoms, n_segs))
    assert list(got) == [False, False, True, True]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("T,C,n_segs,a0,step,width", SEG_DIRTY_GEOMS[:3])
def test_leading_key_axis_is_per_key_reference(T, C, n_segs, a0, step,
                                               width):
    K = 5
    x = _pw_rows(C, T, 7 + T, lead=(K,)).astype(np.float32)
    geoms = [(a0, step, width)]
    got = _port([x], geoms, n_segs)
    assert got.shape == (K, n_segs)
    for k in range(K):
        want = np.asarray(rref.seg_dirty_fused_ref([jnp.asarray(x[k])],
                                                   geoms, n_segs))
        assert np.array_equal(got[k], want), k


def test_grid_mats_keeps_leaves_in_place_with_the_reference_flags():
    """A dict-valued grid (f32 and bool leaves) with φ gaps: the port's
    per-leaf views give the flags of the reference's per-dtype stacks."""
    T, n_segs = 256, 8
    rng = np.random.default_rng(3)
    price = _pw_rows(1, T, 5)[0].astype(np.float32)
    flag = rng.random(T) < 0.02
    valid = np.ones(T, bool)
    valid[100:130] = False
    value = {"price": price, "flag": flag}
    tval = {k: torch.from_numpy(v) for k, v in value.items()}
    tvalid = torch.from_numpy(valid)
    mats = sc.grid_mats(tval, tvalid)
    assert len(mats) == 3 and all(m.shape == (1, T) for m in mats)
    assert mats[-1].data_ptr() == tvalid.data_ptr()        # a view
    geoms = [(-8, 32, 40)]
    got = sc.seg_dirty(mats, geoms * len(mats), n_segs).numpy()
    rmats = rsc.grid_mats({k: jnp.asarray(v) for k, v in value.items()},
                          jnp.asarray(valid))
    want = np.asarray(rsc.seg_dirty(rmats, geoms * len(rmats), n_segs,
                                    pallas=True))
    assert np.array_equal(got, want)


def test_plain_version_is_what_the_wrapper_runs_on_the_cpu():
    x = torch.from_numpy(_pw_rows(2, 96, 1).astype(np.float32))
    geoms = [(-3, 24, 30)]
    assert torch.equal(sc.seg_dirty([x], geoms, 4),
                       ref.seg_dirty_fused_ref([x], geoms, 4))
    assert sc.launches["seg_dirty"] == 0    # no kernel on the CPU


# every dtype a grid can carry: the reference's oracle where jax holds the
# dtype without x64 (f16, bf16, int16, int8, uint8), and a numpy oracle of
# the value comparison for f64 and int64 (jax without x64 would narrow them)
_JAX_DTYPES = [(torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16),
               (torch.int16, jnp.int16), (torch.int8, jnp.int8),
               (torch.uint8, jnp.uint8)]


@pytest.mark.parametrize("tdt,jdt", _JAX_DTYPES)
@pytest.mark.parametrize("T,C,n_segs,a0,step,width", SEG_DIRTY_GEOMS[:4])
def test_plain_seg_dirty_every_dtype_matches_reference(T, C, n_segs, a0,
                                                       step, width, tdt,
                                                       jdt):
    x = _pw_rows(C, T, T * 7 + n_segs)
    geoms = [(a0, step, width)]
    got = sc.seg_dirty([torch.from_numpy(x).to(tdt)], geoms, n_segs)
    want = np.asarray(rref.seg_dirty_fused_ref([jnp.asarray(x, jdt)], geoms,
                                               n_segs))
    assert np.array_equal(got.numpy(), want)


def _numpy_seg_dirty(x, geom, n_segs):
    a0, step, width = geom
    T = x.shape[-1]
    d = (x[..., 1:] != x[..., :-1]).any(axis=-2)       # d[t-1]: tick t
    out = np.zeros(x.shape[:-2] + (n_segs,), bool)
    for k in range(n_segs):
        lo, hi = max(a0 + k * step, 1), min(a0 + k * step + width, T)
        if hi > lo:
            out[..., k] = d[..., lo - 1:hi - 1].any(axis=-1)
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64])
def test_plain_seg_dirty_wide_dtypes(dtype):
    """f64 and int64 compare as themselves: int64 values 2**40 + 1 and
    2**40 differ (they would not after a cast through f32), f64 NaN is a
    change and -0.0 is not."""
    T, n_segs, geom = 128, 4, (0, 32, 32)
    x = np.zeros((2, 1, T))
    if dtype == torch.int64:
        x = np.full((2, 1, T), 2 ** 40, np.int64)
        x[0, 0, 50] += 1                  # one tick of 2**40 + 1
    else:
        x[0, 0, 10:20] = -0.0
        x[0, 0, 50] = np.nan
    x[1, 0, 100:] = 3
    got = sc.seg_dirty([torch.from_numpy(x).to(dtype)], [geom], n_segs)
    want = _numpy_seg_dirty(x, geom, n_segs)
    assert np.array_equal(got.numpy(), want)
    assert want[0].tolist() == [False, True, False, False]
    assert want[1].tolist() == [False, False, False, True]
