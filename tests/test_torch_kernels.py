"""Port kernels: the plain PyTorch versions (what a CPU tensor runs) against
the reference's Pallas kernels in interpret mode.  The CUDA kernels are
held against the plain versions in tests/test_torch_cuda.py and by
chip_smoke.py.

Tolerances: max/min select one of the inputs, so they are exact.  Sums
add the same f32 terms in another order, so both packages are held against
the f64 result: the port may be at most twice as far from it as the
reference is, plus 4 ulps of the largest sum formed (``_assert_sums``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import window_reduce as rwr
from repro_torch.kernels import ops, window_reduce as wr

EPS32 = float(np.finfo(np.float32).eps)

# the reference's kernel sweep (tests/test_kernels.py SHAPES): (T, C, W),
# window > T included
SHAPES = [(64, 1, 8), (257, 2, 16), (533, 3, 37), (1024, 4, 128),
          (100, 1, 100), (96, 2, 256)]
SMALL_W = [(300, 2, 1), (300, 2, 3), (129, 1, 7)]

JNP_COMBINE = {"add": (jnp.add, 0.0), "max": (jnp.maximum, -jnp.inf),
               "min": (jnp.minimum, jnp.inf)}


def _data(T, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C, T)).astype(np.float32),
            rng.random(T) > 0.25)


def _assert_sums(got, want, exact, scale=None):
    """``scale``: the largest sum formed (default: the largest result)."""
    exact = np.asarray(exact, np.float64)
    e_ref = np.abs(np.asarray(want, np.float64) - exact).max(initial=0.0)
    if scale is None:
        scale = np.abs(exact).max(initial=0.0)
    tol = 2 * e_ref + 4 * EPS32 * scale
    np.testing.assert_allclose(np.asarray(got, np.float64), exact, rtol=0,
                               atol=tol)


def _window_sums64(x, W):
    """Exact trailing W-tick sums along the last axis, in f64."""
    p = np.cumsum(np.asarray(x, np.float64), axis=-1)
    shifted = np.concatenate([np.zeros(p.shape[:-1] + (W,)), p], -1)
    return p - shifted[..., :p.shape[-1]]


@pytest.mark.parametrize("T,C,W", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_scan_plain_matches_pallas(T, C, W, dtype):
    x, _ = _data(T, C, T + C)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(rwr.prefix_scan(xj, block=64, interpret=True))
    # the bf16 values themselves, carried exactly through f32
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = wr.prefix_scan(xt)
    assert got.dtype == torch.float32
    _assert_sums(got.numpy(), want,
                 np.cumsum(np.asarray(xj, np.float64), axis=-1))


@pytest.mark.parametrize("T,C,W", SHAPES)
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_sliding_assoc_plain_matches_pallas(T, C, W, op):
    x, _ = _data(T, C, T * 7 + W)
    comb, ident = JNP_COMBINE[op]
    want = np.asarray(rwr.sliding_assoc(jnp.asarray(x), W, comb, ident,
                                        interpret=True))
    got = wr.sliding_assoc(torch.from_numpy(x), W, op).numpy()
    if op == "add":
        _assert_sums(got, want, _window_sums64(x, W))
    else:
        assert np.array_equal(got, want)


# the masked wrappers: against the reference's wrappers through its Pallas
# kernels (interpret mode) on a few shapes, and through its plain jnp path
# on the whole sweep
OPS_CASES = ([(T, C, W, True) for T, C, W in SHAPES[2:3] + SMALL_W] +
             [(T, C, W, False) for T, C, W in SHAPES])


@pytest.mark.parametrize("T,C,W,pallas", OPS_CASES)
@pytest.mark.parametrize("algo", ["block", "soe"])
def test_ops_sliding_sum_matches_reference(T, C, W, pallas, algo):
    x, valid = _data(T, C, T + W)
    s_r, n_r = rops.sliding_sum(jnp.asarray(x), jnp.asarray(valid), W,
                                pallas=pallas, algo=algo)
    s, n = ops.sliding_sum(torch.from_numpy(x), torch.from_numpy(valid), W,
                           algo=algo)
    xm = np.where(valid, x, 0)
    # below 8 ticks and under soe the prefix sums are what is rounded
    prefix = W < 8 or algo == "soe"
    _assert_sums(s.numpy(), s_r, _window_sums64(xm, W),
                 scale=np.abs(np.cumsum(xm, -1)).max() if prefix else None)
    # counts are integers: exact in either order
    assert np.array_equal(n.numpy(), np.asarray(n_r))


@pytest.mark.parametrize("T,C,W,pallas", OPS_CASES)
@pytest.mark.parametrize("op", ["max", "min"])
def test_ops_sliding_assoc_matches_reference(T, C, W, pallas, op):
    x, valid = _data(T, C, T * 3 + W)
    v_r, a_r = rops.sliding_assoc(jnp.asarray(x), jnp.asarray(valid), W, op,
                                  pallas=pallas)
    v, a = ops.sliding_assoc(torch.from_numpy(x), torch.from_numpy(valid),
                             W, op)
    assert np.array_equal(v.numpy(), np.asarray(v_r))
    assert np.array_equal(a.numpy(), np.asarray(a_r))


def test_ops_keyed_rows_equal_per_key_rows():
    """A leading key axis folds into the kernels' row axis: each key's
    result equals that key run alone."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 4, 300)).astype(np.float32))
    valid = torch.from_numpy(rng.random((4, 300)) > 0.3)
    for W in (3, 20):
        s, n = ops.sliding_sum(x, valid, W)
        v, a = ops.sliding_assoc(x[:1], valid, W, "min")
        for k in range(4):
            sk, nk = ops.sliding_sum(x[:, k], valid[k], W)
            vk, ak = ops.sliding_assoc(x[:1, k], valid[k], W, "min")
            assert torch.equal(s[:, k], sk) and torch.equal(n[k], nk)
            assert torch.equal(v[:, k], vk) and torch.equal(a[k], ak)


def test_block_beats_soe_numerics():
    """Block sums keep an error bounded by the window's content; the
    subtract-on-evict sum's error grows with stream position (the
    reference's test_block_beats_soe_numerics, on the port)."""
    T, W = 200_000, 64
    rng = np.random.default_rng(0)
    xs = rng.normal(1000.0, 1.0, T).astype(np.float32)
    x = torch.from_numpy(xs)[None, :]
    valid = torch.ones(T, dtype=torch.bool)
    c = np.concatenate([[0], np.cumsum(xs.astype(np.float64))])
    exact = c[W:] - c[:-W]
    s_block, _ = ops.sliding_sum(x, valid, W, algo="block")
    s_soe, _ = ops.sliding_sum(x, valid, W, algo="soe")
    err_block = np.abs(s_block.numpy()[0, W - 1:] - exact).max()
    err_soe = np.abs(s_soe.numpy()[0, W - 1:] - exact).max()
    assert err_block < 0.5, err_block
    assert err_soe > err_block * 10, (err_soe, err_block)


def test_kernel_wrappers_do_not_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes
    to the kernel's checks and raises there."""
    x = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        wr.prefix_scan(x)
    with pytest.raises(ValueError, match="CUDA"):
        wr.sliding_assoc(x, 8, "add")
