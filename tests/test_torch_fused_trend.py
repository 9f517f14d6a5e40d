"""The port's fused trend kernel on the CPU (its plain version,
``repro_torch.kernels.ref.fused_trend_block_ref``, which the wrapper runs
for CPU tensors) against the reference's Pallas kernel in interpret mode,
and both against a float64 result.

Tolerance: both packages form every window sum from per-stripe f32 prefix
and suffix sums (stripes of ``w2`` ticks), in other orders, so each is
held against f64: the port may be at most twice as far from it as the
reference is, plus 4 ulps of the largest stripe sum.  ``uptrend`` must be
``diff > 0`` of the port's own ``diff``, and agree with the reference's
wherever the f64 ``diff`` is farther from 0 than that tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_query as rfq
from repro_torch.kernels import fused_query as fq

EPS32 = float(np.finfo(np.float32).eps)


def _f64(x: np.ndarray, w1: int, w2: int) -> np.ndarray:
    x = x.astype(np.float64)
    p = np.cumsum(x)
    pos = np.arange(x.shape[0])

    def wmean(w):
        pw = np.concatenate([np.zeros(w), p])[:x.shape[0]]
        return (p - pw) / np.minimum(pos + 1, w)

    return wmean(w1) - wmean(w2)


@pytest.mark.parametrize("T,w1,w2", [(5000, 20, 50), (49, 20, 50),
                                     (1001, 7, 64), (333, 3, 100),
                                     (4096, 100, 1500)])
def test_plain_fused_trend_matches_reference_kernel(T, w1, w2):
    rng = np.random.default_rng(T + w2)
    x = (100.0 + np.cumsum(rng.normal(0, 0.05, T))).astype(np.float32)
    diff, up = fq.fused_trend(torch.from_numpy(x), w1, w2)
    rdiff, rup = rfq.fused_trend(jnp.asarray(x), w1, w2, interpret=True)
    rdiff, rup = np.asarray(rdiff), np.asarray(rup)
    exact = _f64(x, w1, w2)
    assert diff.dtype == torch.float32 and up.dtype == torch.bool
    assert diff.shape == up.shape == (T,)
    e_port = np.abs(diff.numpy().astype(np.float64) - exact).max()
    e_ref = np.abs(rdiff.astype(np.float64) - exact).max()
    tol = 2 * e_ref + 4 * EPS32 * np.abs(x).max() * w2
    assert e_port <= tol, (e_port, e_ref)
    assert torch.equal(up, diff > 0)
    sure = np.abs(exact) > tol
    assert np.array_equal(up.numpy()[sure], rup[sure])


def test_fused_trend_input_checks():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="w1 < w2"):
        fq.fused_trend(x, 50, 20)
    with pytest.raises(ValueError, match=r"\(T,\)"):
        fq.fused_trend(x.reshape(4, 4), 2, 3)
    assert fq.launches["fused_trend"] == 0      # no kernel on the CPU
