"""The port on a CUDA card: each CUDA kernel against its plain version, the
wrappers' input checks, and the query path on the card against the CPU.

Every test here needs a card and the CUDA toolkit: it carries the ``cuda``
marker and skips inside the ``cuda`` fixture where there is none.  The file
imports neither jax nor the reference, so it runs on a machine that has
only the port:  ``python -m pytest -q tests/test_torch_cuda.py``.

Tolerances: max/min select one of the inputs, so they are exact.  Sums
add the same f32 terms in another order, so kernel and plain version are
both held against the f64 result: the kernel may be at most twice as far
from it as the plain version is, plus 4 ulps of the largest sum formed
(``_assert_sums``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compile as qc
from repro_torch.core import parallel as par
from repro_torch.data import apps
from repro_torch.kernels import ops, ref, window_reduce as wr

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and the CUDA toolkit")
    return torch.device("cuda")


def _assert_sums(got, plain, exact, scale=None):
    """``scale``: the largest sum formed (default: the largest result)."""
    e_plain = float((plain.double() - exact).abs().max())
    if scale is None:
        scale = float(exact.abs().max())
    tol = 2 * e_plain + 4 * EPS32 * scale
    assert float((got.double() - exact).abs().max()) <= tol


def _data(T, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C, T)).astype(np.float32),
            rng.random(T) > 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,W", [(64, 1, 8), (257, 2, 16), (533, 3, 37),
                                   (1024, 4, 128), (100, 1, 100),
                                   (96, 2, 256), (100_003, 3, 1000),
                                   (5000, 2, 3001)])
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_cuda_sliding_assoc_matches_plain(cuda, T, C, W, op):
    x, _ = _data(T, C, T + W)
    xt = torch.from_numpy(x).to(cuda)
    combine, ident, _ = wr.COMBINES[op]
    n0 = wr.launches["sliding_assoc"]
    got = wr.sliding_assoc(xt, W, op)
    assert wr.launches["sliding_assoc"] == n0 + 1
    plain = ref.sliding_assoc_block_ref(xt, W, combine, ident)
    if op == "add":
        _assert_sums(got, plain, ref.sliding_assoc_block_ref(
            xt.double(), W, torch.add, 0.0))
    else:
        assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("T,C", [(10, 1), (1025, 3), (1 << 20, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_prefix_scan_matches_plain(cuda, T, C, dtype):
    x, _ = _data(T, C, T)
    xt = torch.from_numpy(x).to(cuda).to(dtype)
    n0 = wr.launches["prefix_scan"]
    got = wr.prefix_scan(xt)
    assert wr.launches["prefix_scan"] == n0 + 1
    assert got.dtype == torch.float32
    _assert_sums(got, ref.prefix_sum_ref(xt.float()),
                 torch.cumsum(xt.double(), dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 7, 8, 50])
@pytest.mark.parametrize("algo", ["block", "soe"])
def test_cuda_ops_match_cpu(cuda, W, algo):
    x, valid = _data(3000, 2, W)
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    s, n = ops.sliding_sum(xt.to(cuda), vt.to(cuda), W, algo=algo)
    s_c, n_c = ops.sliding_sum(xt, vt, W, algo=algo)
    p = torch.cumsum(torch.where(vt, xt, 0.0).double(), dim=-1)
    # below 8 ticks and under soe the prefix sums P are what is rounded
    prefix = W < 8 or algo == "soe"
    _assert_sums(s.cpu(), s_c, p - ref.shift_right(p, W, 0.0),
                 scale=float(p.abs().max()) if prefix else None)
    assert torch.equal(n.cpu(), n_c)
    for op in ("max", "min"):
        v, a = ops.sliding_assoc(xt[:1].to(cuda), vt.to(cuda), W, op)
        v_c, a_c = ops.sliding_assoc(xt[:1], vt, W, op)
        assert torch.equal(v.cpu(), v_c) and torch.equal(a.cpu(), a_c)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(TypeError):
        wr.sliding_assoc(x.double(), 8, "max")
    with pytest.raises(ValueError):
        wr.prefix_scan(x.t())                 # not contiguous
    with pytest.raises(ValueError):
        wr.sliding_assoc(x[None], 8, "add")   # not (R, T)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["trend", "ysb", "vibration"])
def test_cuda_app_matches_cpu(cuda, name):
    """An app on the card, through the kernels, against the same query on
    the CPU at identical partitioning; ysb counts integers: exact."""
    app = apps.make_app(name)
    data = app.make_input(1 << 14, 0)
    exe = qc.compile_query(app.query.node, out_len=(1 << 12) // app.query.prec)
    before = dict(wr.launches)
    got = par.partition_run(exe, apps.make_grids(data), 0, 4)
    assert wr.launches["sliding_assoc"] > before["sliding_assoc"]
    want = par.partition_run(exe, apps.make_grids(data, device="cpu"), 0, 4)
    gv = got.value if isinstance(got.value, dict) else {"v": got.value}
    wv = want.value if isinstance(want.value, dict) else {"v": want.value}
    both = got.valid.cpu() & want.valid
    for k in gv:
        d = (gv[k].cpu()[both] - wv[k][both]).abs()
        assert float(d.max()) <= (0.0 if name == "ysb" else 1e-4), k
    # a > 0 gate may flip only where its operand rounds across 0
    flips = got.valid.cpu() != want.valid
    assert (wv[next(iter(wv))][flips].abs() <= 1e-3).all()
