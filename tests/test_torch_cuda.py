"""The port on a CUDA card: each CUDA kernel against its plain version, the
wrappers' input checks, and the query path on the card against the CPU.

Every test here needs a card and the CUDA toolkit: it carries the ``cuda``
marker and skips inside the ``cuda`` fixture where there is none.  The file
imports neither jax nor the reference, so it runs on a machine that has
only the port:  ``python -m pytest -q tests/test_torch_cuda.py``.

Tolerances: max/min select one of the inputs, so they are exact, and so
are the change-detection flags.  Sums add the same f32 terms in another
order, so kernel and plain version are both held against the f64 result:
the kernel may be at most twice as far from it as the plain version is,
plus 4 ulps of the largest sum formed (``_assert_sums``).  The runner's
sparse body must equal its dense body bit for bit on the card.
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import compile as qc
from repro_torch.core import parallel as par
from repro_torch.core import sparse as sp
from repro_torch.data import apps, streams
from repro_torch.engine import ExecPolicy, Runner, keyed_grid
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import ops, ref, sparse_compact as sc
from repro_torch.kernels import window_reduce as wr

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


# ---------------------------------------------------------------------------
# seg_dirty and fused_trend
# ---------------------------------------------------------------------------

SEG_DIRTY_GEOMS = [(256, 1, 8, 0, 32, 32), (256, 3, 8, -31, 32, 64),
                   (200, 2, 4, 7, 48, 17), (64, 1, 4, -5, 16, 128),
                   (512, 4, 16, 1, 32, 33), (96, 2, 12, -8, 8, 1),
                   (4096 + 129, 2, 2, -129, 64, 194)]


def _pw_rows(shape, seed, rate=0.05):
    rng = np.random.default_rng(seed)
    change = rng.random(shape) < rate
    raw = rng.integers(0, 50, size=shape)
    idx = np.maximum.accumulate(
        np.where(change, np.arange(shape[-1]), -1), axis=-1)
    return np.take_along_axis(raw, np.clip(idx, 0, None), axis=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("T,C,n_segs,a0,step,width", SEG_DIRTY_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool])
def test_cuda_seg_dirty_matches_plain(cuda, T, C, n_segs, a0, step, width,
                                      dtype):
    x = torch.from_numpy(_pw_rows((3, C, T), T + C))
    x = (x % 2 == 1) if dtype == torch.bool else x.to(dtype)
    geoms = [(a0, step, width)]
    n0 = sc.launches["seg_dirty"]
    got = sc.seg_dirty([x.to(cuda)], geoms, n_segs)
    assert sc.launches["seg_dirty"] == n0 + 1
    assert got.dtype == torch.bool and got.shape == (3, n_segs)
    assert torch.equal(got.cpu(), ref.seg_dirty_fused_ref([x], geoms,
                                                          n_segs))


@pytest.mark.cuda
def test_cuda_seg_dirty_edges(cuda):
    """NaN is a change, -0.0 is not; mixed dtypes and geometries; more rows
    than one launch takes; a non-contiguous time axis; no key axis."""
    T, n_segs = 64, 4
    a = torch.zeros(2, 1, T)
    a[0, 0, 10:20] = -0.0
    a[1, 0, 40:44] = float("nan")
    m = torch.ones(2, 1, T, dtype=torch.bool)
    m[0, 0, 56:] = False
    wide = torch.from_numpy(_pw_rows((2, 40, T), 3, rate=0.01)).float()
    strided = torch.from_numpy(_pw_rows((2, T, 3), 4)).int().transpose(1, 2)
    mats = [a, m, wide, strided]
    geoms = [(0, 16, 16), (0, 16, 16), (-3, 16, 20), (2, 16, 9)]
    got = sc.seg_dirty([x.to(cuda) for x in mats], geoms, n_segs)
    assert torch.equal(got.cpu(), ref.seg_dirty_fused_ref(mats, geoms,
                                                          n_segs))
    one = sc.seg_dirty([a[1].to(cuda)], geoms[:1], n_segs)
    assert one.shape == (n_segs,) and one.cpu().tolist() == [
        False, False, True, False]
    with pytest.raises(TypeError):
        sc.seg_dirty([a.double().to(cuda)], geoms[:1], n_segs)


@pytest.mark.cuda
@pytest.mark.parametrize("T,w1,w2", [(1 << 20, 20, 50), (49, 20, 50),
                                     (1001, 7, 64), (100_003, 30, 2000),
                                     (20_000, 100, 5000)])
def test_cuda_fused_trend_matches_plain(cuda, T, w1, w2):
    rng = np.random.default_rng(T)
    x = torch.from_numpy(
        (100 + np.cumsum(rng.normal(0, 0.05, T))).astype(np.float32))
    n0 = fq.launches["fused_trend"]
    diff, up = fq.fused_trend(x.to(cuda), w1, w2)
    assert fq.launches["fused_trend"] == n0 + 1
    pd, _ = ref.fused_trend_block_ref(x, w1, w2)
    x64 = x.double()
    p = torch.cumsum(x64, 0)
    pos = torch.arange(T)

    def wmean(w):
        return (p - ref.shift_right(p, w, 0.0)) / torch.clamp(pos + 1, max=w)

    exact = wmean(w1) - wmean(w2)
    e_k = float((diff.cpu().double() - exact).abs().max())
    e_p = float((pd.double() - exact).abs().max())
    assert e_k <= 2 * e_p + 4 * EPS32 * float(x.abs().max()) * w2
    assert torch.equal(up, diff > 0)


# ---------------------------------------------------------------------------
# the runner on the card
# ---------------------------------------------------------------------------

def _fraud_runners(keyed, n_keys, segs, out_len=64):
    q = streams.fraud_query(64, keyed=keyed).node
    kw = dict(n_keys=n_keys if keyed else None, segs_per_chunk=segs)
    keys = "vmapped" if keyed else "single"
    return (Runner(qc.compile_query(q, out_len=out_len),
                   ExecPolicy(keys=keys), **kw),
            Runner(qc.compile_query(q, out_len=out_len, sparse=True),
                   ExecPolicy(body="sparse", keys=keys), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("keyed", [False, True])
def test_cuda_runner_sparse_equals_dense_and_cpu(cuda, keyed):
    n_keys, segs, n_chunks = 64, 4, 6
    span = 64 * segs
    if keyed:
        vals = streams.keyed_activity(n_keys, span * n_chunks, 0.1, 0)
    else:
        vals = streams.burst_stream(span * n_chunks, 0.05, 0)
    g = {"in": keyed_grid(vals, np.ones(vals.shape, bool))}
    dense, sparse = _fraud_runners(keyed, n_keys, segs)
    n0 = sc.launches["seg_dirty"]
    d = dense.run(g, n_chunks)
    s = sparse.run(g, n_chunks)
    assert sc.launches["seg_dirty"] == n0 + n_chunks
    assert torch.equal(d.valid, s.valid)
    assert torch.equal(d.value[d.valid], s.value[s.valid])
    st = sparse.dirty_stats()
    assert st["dirty_units"] < st["units"]
    cpu_dense, _ = _fraud_runners(keyed, n_keys, segs)
    c = cpu_dense.run({"in": keyed_grid(vals, np.ones(vals.shape, bool),
                                        device="cpu")}, n_chunks)
    both = c.valid & d.valid.cpu()
    assert float((c.value[both] - d.value.cpu()[both]).abs().max()) <= 1e-3
    assert torch.equal(c.valid, d.valid.cpu())


def _count_syncs(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.cuda
@pytest.mark.parametrize("keyed", [False, True])
def test_cuda_steady_chunk_synchronizes_once_sparse_never_dense(cuda,
                                                                keyed):
    """A steady-state sparse chunk reads the device once (the 4-byte dirty
    count that picks the bucket); a dense chunk never."""
    n_keys, segs = 16, 4
    span = 64 * segs
    vals = (streams.keyed_activity(n_keys, 4 * span, 0.25, 1) if keyed
            else streams.burst_stream(4 * span, 0.05, 1))
    chunks = [{"in": keyed_grid(vals[..., c * span:(c + 1) * span],
                                np.ones(vals.shape[:-1] + (span,), bool),
                                t0=c * span)} for c in range(4)]
    dense, sparse = _fraud_runners(keyed, n_keys, segs)
    for r in (dense, sparse):
        r.step(chunks[0])
        r.step(chunks[1])
    assert _count_syncs(lambda: sparse.step(chunks[2])) == 1
    assert _count_syncs(lambda: dense.step(chunks[2])) == 0
    snap = sparse.metrics.snapshot()            # the explicit read
    assert snap["counters"]["runner.chunks"]["value"] == 3
    assert sum(snap["vectors"]["runner.bucket_picks"]["values"]) == 3


@pytest.mark.cuda
def test_cuda_sparse_run_matches_partition_run(cuda):
    exe = qc.compile_query(streams.fraud_query(64).node, out_len=512,
                           sparse=True)
    g = streams.burst_grids(1 << 16, 0.01, 0)
    n0 = sc.launches["seg_dirty"]
    got = sp.sparse_run(exe, g, 0, 128)
    assert sc.launches["seg_dirty"] == n0 + 1
    want = par.partition_run(exe, g, 0, 128)
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.value[got.valid], want.value[want.valid])
