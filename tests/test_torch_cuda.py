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
import math
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.core import compile as qc
from repro_torch.core import parallel as par
from repro_torch.core import sparse as sp
from repro_torch.data import apps, streams
from repro_torch.engine import ExecPolicy, Runner, keyed_grid
from repro_torch.core import region as rg
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import ops, ref, sparse_compact as sc
from repro_torch.kernels import region_program as rp
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


def _nonfinite_rows(R, T, seed):
    """Normal rows with a sprinkling of NaN, +inf and -inf."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (R, T)).astype(np.float32)
    for v in (np.nan, np.inf, -np.inf):
        x[rng.random((R, T)) < 0.002] = v
    return torch.from_numpy(x)


def _assert_window_result(got, plain, exact, op):
    """Equal non-finite pattern (NaN where NaN, each infinity with its
    sign); max/min equal elsewhere, sums within ``_assert_sums``."""
    got = got.cpu()
    assert torch.equal(got.isnan(), plain.isnan())
    assert torch.equal(got.isposinf(), plain.isposinf())
    assert torch.equal(got.isneginf(), plain.isneginf())
    fin = plain.isfinite()
    if op == "add":
        _assert_sums(got[fin], plain[fin], exact[fin])
    else:
        assert torch.equal(got[fin], plain[fin])


# each regime's edges (wr.sliding_regime: short up to SHORT_T = 1024 ticks,
# long below W = 2048, stripe from there): T < 32, T = W, T not a multiple
# of W, T at and just above the threshold, W > T, W >= 1024, R = 1 and
# large R
SLIDING_EDGES = [(1, 5, 2), (3, 31, 8), (2, 100, 100), (4, 533, 37),
                 (2, 1024, 64), (2, 1025, 64), (3, 1024, 1023),
                 (3, 1025, 1024), (2, 96, 256), (1, 900, 1500),
                 (2, 3000, 1024), (2, 5000, 2048), (1, 9000, 4100),
                 (3000, 129, 64), (5000, 577, 50), (1, 1 << 20, 50),
                 (1, 3000, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,T,W", SLIDING_EDGES)
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_cuda_sliding_assoc_regime_edges(cuda, R, T, W, op):
    x = _nonfinite_rows(R, T, R * T + W)
    combine, ident, _ = wr.COMBINES[op]
    got = wr.sliding_assoc(x.to(cuda), W, op)
    plain = ref.sliding_assoc_block_ref(x, W, combine, ident)
    exact = (ref.sliding_assoc_block_ref(x.double(), W, torch.add, 0.0)
             if op == "add" else None)
    _assert_window_result(got, plain, exact, op)


@pytest.mark.cuda
@pytest.mark.parametrize("T,W", [(129, 64), (577, 64), (1024, 50),
                                 (4145, 50), (5000, 3001)])
@pytest.mark.parametrize("op", ["add", "max"])
def test_cuda_sliding_assoc_row_bits_depend_on_the_row_alone(cuda, T, W,
                                                              op):
    """A row gives the same bits alone, at another index among R rows, and
    after a compacting gather (what the sparse body launches)."""
    rng = np.random.default_rng(T + W)
    rows = torch.from_numpy(
        (100 + rng.normal(0, 5, (200, T))).astype(np.float32)).to(cuda)
    row = 77
    alone = wr.sliding_assoc(rows[row:row + 1].contiguous(), W, op)[0]
    among = wr.sliding_assoc(rows, W, op)[row]
    ids = torch.tensor([3, row, 150, 9], device=cuda)
    gathered = wr.sliding_assoc(rows[ids].contiguous(), W, op)[1]
    for other in (among, gathered):
        assert torch.equal(alone.view(torch.int32), other.view(torch.int32))


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


def _misaligned(x):
    """``x`` copied into a contiguous view that starts one element past an
    allocation's start (as ``buf[1:]``): its rows are not 16-byte
    aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    v = buf[1:].view(x.shape)
    v.copy_(x)
    return v


# wr.prefix_plan's edges: one block per row up to PREFIX_TILE, tiles above
PREFIX_EDGES = [1, 31, wr.PREFIX_TILE - 1, wr.PREFIX_TILE,
                wr.PREFIX_TILE + 1, 4105, (1 << 20) + 9]


@pytest.mark.cuda
@pytest.mark.parametrize("T", PREFIX_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "misaligned"])
def test_cuda_prefix_scan_edges(cuda, T, dtype, layout):
    """Odd T, tile edges and a contiguous view off the 16-byte grid, for
    both input types."""
    x, _ = _data(T, 3, T + 1)
    xt = torch.from_numpy(x).to(cuda).to(dtype)
    if layout == "misaligned":
        xt = _misaligned(xt)
        assert xt.data_ptr() % 16 != 0
    n0 = wr.launches["prefix_scan"]
    got = wr.prefix_scan(xt)
    assert wr.launches["prefix_scan"] == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (3, T)
    _assert_sums(got, ref.prefix_sum_ref(xt.float()),
                 torch.cumsum(xt.double(), dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("R,T", [(2, (1 << 20) + 9), (8192, 4105),
                                 (3, 3 * wr.PREFIX_TILE + 5)])
def test_cuda_prefix_scan_bits_repeat(cuda, R, T):
    """The long regime's carries sum the tiles' totals in a fixed order, so
    20 calls give the same bits whatever order the blocks ran in."""
    rng = np.random.default_rng(R + T)
    x = torch.from_numpy(rng.normal(0, 1, (R, T)).astype(np.float32)).to(
        cuda)
    first = wr.prefix_scan(x).view(torch.int32)
    for _ in range(19):
        assert torch.equal(wr.prefix_scan(x).view(torch.int32), first)


@pytest.mark.cuda
@pytest.mark.parametrize("R,T", [(200, 4105), (200, 1000),
                                 (5, (1 << 20) + 9)])
def test_cuda_prefix_scan_row_bits_depend_on_the_row_alone(cuda, R, T):
    """A row gives the same bits alone, among R rows and after a gather."""
    rng = np.random.default_rng(T)
    rows = torch.from_numpy(
        (100 + rng.normal(0, 5, (R, T))).astype(np.float32)).to(cuda)
    row = R // 2 + 1
    alone = wr.prefix_scan(rows[row:row + 1].contiguous())[0]
    among = wr.prefix_scan(rows)[row]
    ids = torch.tensor([R - 1, row, 0], device=cuda)
    gathered = wr.prefix_scan(rows[ids].contiguous())[1]
    for other in (among, gathered):
        assert torch.equal(alone.view(torch.int32), other.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("R,T", [(3, (1 << 20) + 9), (64, 4105),
                                 (5, wr.PREFIX_TILE + 1), (7, 33)])
def test_cuda_prefix_scan_counts_exactly(cuda, R, T):
    """On 0/1 data every partial sum is an integer below 2**24: the kernel
    equals torch.cumsum exactly."""
    g = torch.Generator().manual_seed(T)
    x = (torch.rand(R, T, generator=g) < 0.33).float().to(cuda)
    assert torch.equal(wr.prefix_scan(x), torch.cumsum(x, dim=-1))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 7, 8, 50])
@pytest.mark.parametrize("algo", ["block", "soe"])
def test_cuda_ops_match_cpu(cuda, W, algo):
    x, valid = _data(3000, 2, W)
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    s, n = ops.sliding_sum(xt.to(cuda), vt.to(cuda), W, algo=algo)
    s_c, n_c = ops.sliding_sum(xt, vt, W, algo=algo)
    p = torch.cumsum(torch.where(vt, xt, 0.0).double(), dim=-1)
    # under soe the prefix sums P are what is rounded; block sums of every
    # window are bounded by the window's content
    prefix = algo == "soe"
    _assert_sums(s.cpu(), s_c, p - ref.shift_right(p, W, 0.0),
                 scale=float(p.abs().max()) if prefix else None)
    assert torch.equal(n.cpu(), n_c)
    for op in ("max", "min"):
        v, a = ops.sliding_assoc(xt[:1].to(cuda), vt.to(cuda), W, op)
        v_c, a_c = ops.sliding_assoc(xt[:1], vt, W, op)
        assert torch.equal(v.cpu(), v_c) and torch.equal(a.cpu(), a_c)


# masked_rows: each input laid out so the plan takes the form named
MASKED_LAYOUTS = ["flat", "flat_misaligned", "rows_aligned",
                  "rows_misaligned"]
_F32_SPECIALS = torch.tensor([0x7FC00001, 0xFFC12345, 0x7F800000,
                              0xFF800000, 0, 0x80000000],
                             dtype=torch.int64).to(torch.int32).view(
                                 torch.float32)


def _masked_inputs(C, B, T, layout, seed, dev):
    """``C`` f32 channels and a bool validity ``(*B, T)`` on ``dev`` with
    NaN payloads, infinities and signed zeros, laid out as ``layout``:
    one contiguous run each at an aligned or a misaligned address, or rows
    of a wider buffer (stride T + 8 from an aligned start, or T + 5 from
    an odd one)."""
    g = torch.Generator().manual_seed(seed)
    pad, off = {"flat": (0, 0), "flat_misaligned": (0, 1),
                "rows_aligned": (8, 0), "rows_misaligned": (5, 3)}[layout]
    flat = layout.startswith("flat")
    n = math.prod(B) * T
    chans = []
    for _ in range(C):
        if flat:
            buf = torch.randn(off + n, generator=g)
            x = buf[off:].view(B + (T,))
        else:
            x = torch.randn(B + (T + pad,), generator=g)[..., off:off + T]
        if x.numel():
            at = torch.randint(0, x.numel(), (min(64, x.numel()),),
                               generator=g)
            x.reshape(-1)[at] = _F32_SPECIALS[torch.arange(at.numel())
                                              % _F32_SPECIALS.numel()]
        chans.append(x)
    if flat:
        valid = (torch.rand(off + n, generator=g) > 0.3)[off:].view(B + (T,))
    else:
        valid = (torch.rand(B + (T + pad,), generator=g)
                 > 0.3)[..., off:off + T]

    def to_dev(t):
        # the same strides and offset on the card
        base = torch.empty(t.untyped_storage().nbytes() // t.element_size(),
                           dtype=t.dtype, device=dev)
        view = base.as_strided(t.shape, t.stride(), t.storage_offset())
        view.copy_(t)
        return view
    return chans, valid, [to_dev(c) for c in chans], to_dev(valid)


def _bits32(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MASKED_LAYOUTS)
@pytest.mark.parametrize("T", [1, 5, 8660, 8665])
@pytest.mark.parametrize("op", ["add", "max", "min"])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_cuda_masked_rows_equal_the_plain_version_bit_for_bit(cuda, C, op,
                                                              T, layout):
    """Both forms of the kernel, at odd T, row strides and misaligned
    views, against ``masked_rows_ref`` bit for bit: NaN payloads, the
    ±inf fill and min's -0.0 validity included, in one launch."""
    B = (4,) if T > 1000 else (2, 6)
    chans, valid, xd, vd = _masked_inputs(C, B, T, layout, C * T + len(op),
                                          cuda)
    R = math.prod(B)
    rows = [x.reshape(R, T) for x in xd]   # views: every layout folds
    plan = wr.masked_plan(R, T, [x.data_ptr() for x in rows],
                          [x.stride(0) for x in rows],
                          vd.data_ptr(), vd.reshape(R, T).stride(0))
    want_vec = (layout in ("flat", "rows_aligned") and
                (R * T if layout == "flat" else T) % 4 == 0)
    assert plan.vec == want_vec
    n0, c0 = dict(wr.launches), dict(wr.copies)
    got = wr.masked_rows(xd, vd, op)
    torch.cuda.synchronize()
    assert wr.launches["masked_rows"] == n0["masked_rows"] + 1
    assert wr.copies == c0
    want = ref.masked_rows_ref(chans, valid, op)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(_bits32(got.cpu()), _bits32(want))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [(0,), (5,), (2, 3)])
def test_cuda_masked_rows_copy_only_what_they_cannot_read(cuda, B):
    """No rows (nothing launched), a broadcast validity (read in place), an
    integer channel and one whose ticks are not contiguous (copied, and
    counted), all bit for bit as the plain version."""
    T = 37
    g = torch.Generator().manual_seed(len(B))
    x = torch.randn(B + (T,), generator=g)
    xi = torch.randint(-5, 5, B + (T,), generator=g, dtype=torch.int32)
    xt = torch.randn((T,) + B, generator=g)       # ticks first
    valid = torch.rand(T, generator=g) > 0.5
    n0, c0 = dict(wr.launches), dict(wr.copies)
    got = wr.masked_rows([x.to(cuda), xi.to(cuda),
                          xt.to(cuda).movedim(0, -1)], valid.to(cuda), "max")
    torch.cuda.synchronize()
    want = ref.masked_rows_ref([x, xi.float(), xt.movedim(0, -1)],
                               valid.expand(B + (T,)), "max")
    assert torch.equal(_bits32(got.cpu()), _bits32(want))
    some = math.prod(B) > 0
    assert wr.launches["masked_rows"] - n0["masked_rows"] == int(some)
    assert (wr.copies["masked_rows"] - c0["masked_rows"]
            == (2 if some else 0))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flat", "rows_misaligned"])
def test_cuda_masked_rows_in_a_captured_graph(cuda, layout):
    """Captured once, replayed on new inputs written into the captured
    ones: bit for bit the plain version each time."""
    C, B, T = 2, (96,), 8665
    chans, valid, xd, vd = _masked_inputs(C, B, T, layout, 7, cuda)
    out = wr.masked_rows(xd, vd, "min")      # warm-up: the library loads
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wr.masked_rows(xd, vd, "min")
    for seed in (8, 9):
        chans, valid, xn, vn = _masked_inputs(C, B, T, layout, seed, cuda)
        for dst, src in zip(xd + [vd], xn + [vn]):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = ref.masked_rows_ref(chans, valid, "min")
        assert torch.equal(_bits32(out.cpu()), _bits32(want))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [3, 8, 50, 400])
@pytest.mark.parametrize("algo", ["block", "soe"])
def test_cuda_ops_equal_the_old_composition_bit_for_bit(cuda, W, algo):
    """``ops`` on the card, fed a channel list of row-strided views as
    ``_eval_reduce`` feeds it, against the composition it ran before the
    kernel (a stack, a where, a cast and a cat) into the same window
    kernels: the same bits, NaN and inf payloads included."""
    C, B, T = 2, (24,), 3000
    chans, valid, xd, vd = _masked_inputs(C, B, T, "rows_misaligned", W,
                                          cuda)
    stacked = torch.stack(xd)
    old = torch.cat([torch.where(vd.unsqueeze(0), stacked, 0.0).float(),
                     vd.unsqueeze(0).float()]).reshape(-1, T)
    if algo == "block":
        s_old = wr.sliding_assoc(old, W, "add")
    else:
        p = wr.prefix_scan(old)
        s_old = p - ref.shift_right(p, W, 0.0)
    s, n = ops.sliding_sum(xd, vd, W, algo=algo)
    s_old = s_old.reshape((C + 1,) + B + (T,))
    assert torch.equal(_bits32(s), _bits32(s_old[:C]))
    assert torch.equal(_bits32(n), _bits32(s_old[C]))
    for op in ("max", "min"):
        combine, ident, _ = wr.COMBINES[op]
        xm = torch.where(vd.unsqueeze(0), stacked, ident).float()
        if W < 8:       # the shift-combine of short max/min windows
            want_v, want_a = ref.sliding_assoc_ref(xm, vd, W, combine, ident)
        else:
            vch = vd.unsqueeze(0).float()
            old = torch.cat([xm, -vch if op == "min" else vch])
            o = wr.sliding_assoc(old.reshape(-1, T), W, op).reshape(
                old.shape)
            want_v = o[:C]
            want_a = (o[C] < -0.5) if op == "min" else (o[C] > 0.5)
        v, a = ops.sliding_assoc(xd, vd, W, op)
        assert torch.equal(_bits32(v), _bits32(want_v))
        assert torch.equal(a, want_a)


@pytest.mark.cuda
@pytest.mark.parametrize("name,windows", [("qrs", 5), ("ysb", 1)])
def test_cuda_captured_step_builds_each_window_in_one_launch(cuda, name,
                                                             windows):
    """One captured step of the benchmark's apps: every window kernel's
    rows come from one ``masked_rows`` launch, with nothing copied first
    (qrs: the two 6-tick, the 32- and the 30-tick sums and the 2 s max;
    ysb: the tumbling count)."""
    K, segs = 4, 2
    if name == "ysb":
        exe = qc.compile_query(
            apps.make_keyed_app("ysb", win=1000).query.node, 1)
    else:
        exe = qc.compile_query(apps.make_keyed_app("qrs").query.node, 512)
    r = Runner(exe, ExecPolicy(keys="vmapped"), n_keys=K,
               segs_per_chunk=segs)
    span = r.spec.input_specs["in"].core * segs
    rng = np.random.default_rng(31)
    ok = np.ones((K, span), bool)
    for c in range(3):
        if name == "ysb":
            vals = {"etype": rng.integers(0, 3, (K, span)).astype(
                np.float32)}
        else:
            vals = rng.integers(-1024, 1024, (K, span)).astype(np.float32)
        n0, c0 = dict(wr.launches), dict(wr.copies)
        r.step({"in": keyed_grid(vals, ok, t0=c * span)})
        torch.cuda.synchronize()
    assert r.metrics.tracer.captures(), "the step was not captured"
    d = {k: wr.launches[k] - n0[k] for k in wr.launches}
    assert d["masked_rows"] == windows and d["sliding_assoc"] == windows, d
    assert wr.copies == c0, (wr.copies, c0)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(TypeError):
        wr.sliding_assoc(x.double(), 8, "max")
    with pytest.raises(ValueError):
        wr.prefix_scan(x.t())                 # not contiguous
    with pytest.raises(ValueError):
        wr.sliding_assoc(x[None], 8, "add")   # not (R, T)
    with pytest.raises(ValueError):               # more than one launch
        wr.masked_rows([x] * (wr.MASKED_MAX_CH + 1), x > 0, "add")


# ---------------------------------------------------------------------------
# region_program
# ---------------------------------------------------------------------------

# opcodes a random program draws, by the dtypes they compute in
_RP_BINARY = {rp.F32: ("add", "sub", "mul", "div", "min", "max"),
              rp.I32: ("add", "sub", "mul", "min", "max", "and", "or", "xor"),
              rp.BOOL: ("and", "or", "xor")}
_RP_UNARY = {rp.F32: ("recip", "neg", "abs"), rp.I32: ("neg", "abs", "not"),
             rp.BOOL: ("not",)}
_RP_COMPARE = ("eq", "ne", "lt", "le", "gt", "ge")


def _random_program(seed: int, T: int, size: int = 18):
    """A random program over 1-4 slots of random dtypes, some of whose
    stages read out of range, with inputs for it on the CPU: every opcode
    and cast can come up.  Scheduled as the lowering schedules (constants
    as immediates, loads first, registers reused); one that needs more
    registers than the kernel has is drawn again, smaller."""
    rng = np.random.default_rng(seed)
    ins, dts, slots, leaves, vals, valids = [], [], [], [], [], []

    def emit(op, dt, a=-1, b=-1, c=-1, imm=0, res=None):
        ins.append(rp.Ins(op, dt, len(dts), a, b, c, imm))
        dts.append(dt if res is None else res)
        return len(dts) - 1

    B = (3, 5)
    for k in range(int(rng.integers(1, 5))):
        Ts = T + int(rng.integers(0, 6))
        if rng.random() < 0.5:
            stages = ((int(rng.integers(-3, Ts - T + 4)), Ts),)
        else:
            stages = ((int(rng.integers(-2, 3)), T + 1),
                      (int(rng.integers(-2, Ts - T + 2)), Ts))
        slots.append(stages)
        dt = int(rng.integers(0, 3))
        x = rng.normal(size=B + (Ts,)) * 4
        x[rng.random(x.shape) < 0.1] = 0
        vals.append(torch.from_numpy(x).to(rp.DTYPES[dt]) if dt != rp.F32
                    else torch.from_numpy(x.astype(np.float32)))
        valids.append(torch.from_numpy(rng.random(B + (Ts,)) > 0.2))
        leaves.append((k, 0, dt))
        emit("load", dt, k)

    def reg(dt):
        have = [r for r, d in enumerate(dts) if d == dt]
        if not have or rng.random() < 0.15:
            if rng.random() < 0.5:
                v = {rp.F32: float(np.float32(rng.normal() * 3)),
                     rp.I32: int(rng.integers(-9, 10)),
                     rp.BOOL: bool(rng.random() < 0.5)}[dt]
                return emit("const", dt, imm=v)
            src = int(rng.integers(0, len(dts)))
            return emit("cast", dt, src, imm=dts[src])
        return int(rng.choice(have))

    while len(ins) < size:
        dt = int(rng.integers(0, 3))
        kind = rng.random()
        if kind < 0.4:
            emit(str(rng.choice(_RP_BINARY[dt])), dt, reg(dt), reg(dt))
        elif kind < 0.55:
            emit(str(rng.choice(_RP_UNARY[dt])), dt, reg(dt))
        elif kind < 0.7:
            emit(str(rng.choice(_RP_COMPARE)), dt, reg(dt), reg(dt),
                 res=rp.BOOL)
        elif kind < 0.8:
            emit("where", dt, reg(rp.BOOL), reg(dt), reg(dt))
        elif kind < 0.9 and dt == rp.F32:
            emit("divc", dt, reg(dt), imm=float(rng.choice([8.0, 3.0, -0.7])))
        else:
            reg(dt)
    n_body = len(dts)
    ok = emit("loadv", rp.BOOL, 0)
    for k in range(1, len(slots)):
        ok = emit("and", rp.BOOL, ok, emit("loadv", rp.BOOL, k))
    ok = emit("and", rp.BOOL, ok, reg(rp.BOOL))
    outs = [(int(r), dts[r]) for r in rng.choice(
        np.arange(max(0, n_body - 6), n_body), 3, replace=False)]
    ins, n_regs, phys = rg._schedule(ins, {ok} | {r for r, _ in outs})
    if n_regs > rp.MAX_REGS:
        return _random_program(seed, T, size - 2)
    prog = rp.Program(length=T, slots=tuple(slots), leaves=tuple(leaves),
                      ins=tuple(ins), n_regs=n_regs,
                      outs=tuple((phys[r], dt) for r, dt in outs),
                      ok=phys[ok])
    return prog, valids, vals


def _same_bits(got, want):
    """Equal bits, any NaN equal to any NaN (their payloads are the
    kernels', which torch.minimum and torch.maximum do not fix)."""
    if got.dtype == torch.float32:
        nan = torch.isnan(got)
        assert torch.equal(nan, torch.isnan(want))
        got, want = got.masked_fill(nan, 0), want.masked_fill(nan, 0)
        return torch.equal(_bits32(got), _bits32(want))
    return torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(16))
def test_cuda_region_program_equals_the_plain_version_on_random_programs(
        cuda, seed):
    """Random programs (every opcode, cast and dtype; reads in and out of
    range; strided rows): the kernel against ``region_program_ref`` run
    on the card, bit for bit."""
    prog, valids, vals = _random_program(seed, 700)
    vd = [v.to(cuda) for v in valids]
    xd = [x.to(cuda) for x in vals]
    if seed % 2:            # rows of another stride: views of wider rows
        xd = [torch.cat([x, x[..., :7]], -1)[..., :x.shape[-1]] for x in xd]
    n0 = rp.launches["region_program"]
    outs, valid = rp.region_program(prog, vd, xd)
    torch.cuda.synchronize()
    assert rp.launches["region_program"] == n0 + 1
    w_outs, w_valid = ref.region_program_ref(prog, vd, xd)
    assert torch.equal(valid, w_valid)
    for got, want in zip(outs, w_outs):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert _same_bits(got, want)


def _qrs_regions(out_len: int):
    """qrs's three regions at partitions of ``out_len`` ticks, each with
    random sources of the unit windows' shape, one of them a strided
    view."""
    exe = qc.compile_query(apps.make_keyed_app("qrs").query.node, out_len)
    return [r for r in exe.regions.by_root.values()], exe.plan


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [96 * 32])
def test_cuda_region_program_runs_qrs_regions_bit_for_bit(cuda, rows):
    """qrs's three regions at the benchmark cell's unit windows (3072 rows
    of 8192 output ticks, the sources 8192-8665 ticks long), one source a
    strided view: one launch each, against the plain version on the card
    bit for bit, nothing copied."""
    regions, qp = _qrs_regions(8192)
    gen = torch.Generator(device=cuda).manual_seed(7)
    for r in regions:
        args = []
        for i, s in enumerate(r.sources):
            L = qp.plan_of(s).length
            w = L + (5 if i == 0 else 0)
            v = torch.randint(-2**20, 2**20, (rows, w), device=cuda,
                              generator=gen).float() / 64
            m = torch.rand((rows, w), device=cuda, generator=gen) > 0.1
            args.append((v[:, :L], m[:, :L]))
        n0, c0 = rp.launches["region_program"], rp.copies["region_program"]
        got = r.run(args)
        torch.cuda.synchronize()
        assert r.status == "lowered", (r.root.name, r.status)
        assert rp.launches["region_program"] == n0 + 1
        assert rp.copies["region_program"] == c0
        low = r._lowered[-1][1]
        want = ref.region_program_ref(
            low.program, [args[src][1] for src, _, _ in r.slots],
            [args[r.slots[k][0]][0] for k, _, _ in low.program.leaves])
        assert torch.equal(got[1], want[1])
        assert _same_bits(got[0], want[0][0])


@pytest.mark.cuda
def test_cuda_region_program_in_a_captured_graph(cuda):
    """A launch captured in a graph and replayed twice over new inputs
    copied into its buffers: the bits of an eager launch each time."""
    prog, valids, vals = _random_program(3, 1500)
    vd = [v.to(cuda) for v in valids]
    xd = [x.to(cuda) for x in vals]
    rp.region_program(prog, vd, xd)        # warm-up: the library loads
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs, valid = rp.region_program(prog, vd, xd)
    for seed in (11, 12):
        _, valids2, vals2 = _random_program(seed, 1500)
        for dst, src in zip(vd + xd, valids2 + vals2):
            if dst.shape == src.shape:
                dst.copy_(src.to(dst.dtype))
        g.replay()
        torch.cuda.synchronize()
        w_outs, w_valid = rp.region_program(prog, vd, xd)
        assert torch.equal(valid, w_valid)
        for got, want in zip(outs, w_outs):
            assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,regions", [("qrs", 3), ("ysb", 1)])
def test_cuda_captured_step_runs_each_region_in_one_launch(cuda, name,
                                                           regions):
    """One captured step of the benchmark's apps: each elementwise region
    is one ``region_program`` launch, nothing copied, and the gauges read
    every region lowered."""
    K, segs = 4, 2
    if name == "ysb":
        exe = qc.compile_query(
            apps.make_keyed_app("ysb", win=1000).query.node, 1)
    else:
        exe = qc.compile_query(apps.make_keyed_app("qrs").query.node, 512)
    r = Runner(exe, ExecPolicy(keys="vmapped"), n_keys=K,
               segs_per_chunk=segs)
    span = r.spec.input_specs["in"].core * segs
    rng = np.random.default_rng(31)
    ok = np.ones((K, span), bool)
    for c in range(3):
        if name == "ysb":
            vals = {"etype": rng.integers(0, 3, (K, span)).astype(
                np.float32)}
        else:
            vals = rng.integers(-1024, 1024, (K, span)).astype(np.float32)
        n0, c0 = dict(rp.launches), dict(rp.copies)
        r.step({"in": keyed_grid(vals, ok, t0=c * span)})
        torch.cuda.synchronize()
    assert r.metrics.tracer.captures(), "the step was not captured"
    assert rp.launches["region_program"] - n0["region_program"] == regions
    assert rp.copies == c0, (rp.copies, c0)
    gauges = r.metrics.snapshot()["gauges"]
    assert gauges["runner.regions_lowered"]["value"] == regions
    assert not [k for k in gauges if k.startswith("runner.regions_eager")]


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
        sc.seg_dirty([a.to(torch.complex64).to(cuda)], geoms[:1], n_segs)


_GRID_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
                torch.int64, torch.int32, torch.int16, torch.int8,
                torch.uint8, torch.bool]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _GRID_DTYPES)
@pytest.mark.parametrize("T,width,step,n_segs", [(300, 64, 32, 8),
                                                 (3200, 577, 512, 6)])
def test_cuda_seg_dirty_every_dtype(cuda, dtype, T, width, step, n_segs):
    """Every dtype a grid carries, read in place, against the plain
    version: warp units and block units, aligned rows and a row one element
    off its vector grid, and for floats NaN (a change) and -0.0 (none)."""
    # about one change per unit's width in a row, so some units stay clean
    x = torch.from_numpy(_pw_rows((3, 2, T), T + n_segs,
                                  rate=0.25 / width))
    if dtype.is_floating_point:
        x = x.to(dtype)
        x[0, 0, 40:60] = -0.0
        x[1, 1, T // 2:T // 2 + 3] = float("nan")
    elif dtype == torch.int64:
        x = x.to(dtype) + (1 << 40)       # beyond f32's exact integers
        x[2, 0, T // 3] += 1
    else:
        x = (x > 25) if dtype == torch.bool else x.to(dtype)
    geoms = [(-3, step, width)]
    for mat in (x, x[..., 1:]):            # a view off the vector grid
        got = sc.seg_dirty([mat.to(cuda)], geoms, n_segs)
        want = ref.seg_dirty_fused_ref([mat], geoms, n_segs)
        assert torch.equal(got.cpu(), want), dtype
        assert want.any() and not want.all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool])
def test_cuda_seg_dirty_long_units(cuda, dtype):
    """Units wider than LONG_UNIT (a block each): a change at a unit's
    first and at its last tick, NaN and -0.0, int32 and bool rows,
    accumulation over several launches (more rows than one launch
    takes)."""
    width, step, n_segs = 577, 512, 6
    T = step * n_segs + 65
    assert sc.seg_dirty_plan(3 * n_segs, width)[0] == 256
    x = torch.zeros(3, 2, T)
    x[0, 0, 1] = 1.0                         # first tick of unit 0
    x[0, 1, 512 + 576:] = 2.0                # last tick of unit 1 (+ on)
    x[1, 0, 1030:1040] = -0.0                # no change
    x[1, 1, 2100] = float("nan")             # a change (and its return)
    x[2, 0, 5 * step + 300] = 3.0
    if dtype != torch.float32:
        x = torch.nan_to_num(x, nan=7.0)
        x = (x != 0) if dtype == torch.bool else x.to(dtype)
    geoms = [(0, step, width)]
    got = sc.seg_dirty([x.to(cuda)], geoms, n_segs)
    want = ref.seg_dirty_fused_ref([x], geoms, n_segs)
    assert torch.equal(got.cpu(), want)
    assert want.any() and not want.all()
    # 40 channels of one source: three launches OR-ed into one output
    wide = torch.from_numpy(_pw_rows((3, 40, T), 5, rate=3e-5)).to(dtype)
    n0 = sc.launches["seg_dirty"]
    got = sc.seg_dirty([wide.to(cuda), x.to(cuda)], geoms * 2, n_segs)
    assert sc.launches["seg_dirty"] == n0 + 3
    assert torch.equal(got.cpu(), ref.seg_dirty_fused_ref(
        [wide, x], geoms * 2, n_segs))


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


def _assert_trend(x, w1, w2, diff, up):
    """``diff`` within the stripe formulation's bound of the f64 result
    (as test_cuda_fused_trend_matches_plain), ``up == diff > 0``."""
    x = x.cpu()
    T = x.shape[0]
    pd, _ = ref.fused_trend_block_ref(x, w1, w2)
    p = torch.cumsum(x.double(), 0)
    pos = torch.arange(T)

    def wmean(w):
        return (p - ref.shift_right(p, w, 0.0)) / torch.clamp(pos + 1, max=w)

    exact = wmean(w1) - wmean(w2)
    e_k = float((diff.cpu().double() - exact).abs().max())
    e_p = float((pd.double() - exact).abs().max())
    assert e_k <= 2 * e_p + 4 * EPS32 * float(x.abs().max()) * w2
    assert torch.equal(up, diff > 0)


# block edges of fq.trend_plan: T one past and one short of whole blocks,
# odd T, windows wider than a tile (one stripe a block, walked in tiles)
# with the block boundary inside the tile walk
TREND_EDGES = [(20, 50), (7, 64), (1, 2), (30, 2000), (100, 2048),
               (100, 2049), (1000, 5000), (2, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("w1,w2", TREND_EDGES)
@pytest.mark.parametrize("extra", [-1, 1, 3])
@pytest.mark.parametrize("layout", ["contiguous", "misaligned"])
def test_cuda_fused_trend_edges(cuda, w1, w2, extra, layout):
    span = fq.trend_plan(1, w2).span
    T = 3 * span + extra
    rng = np.random.default_rng(T + w1)
    x = torch.from_numpy(
        (100 + np.cumsum(rng.normal(0, 0.05, T))).astype(np.float32))
    xt = x.to(cuda)
    if layout == "misaligned":
        xt = _misaligned(xt)
        assert xt.data_ptr() % 16 != 0
    diff, up = fq.fused_trend(xt, w1, w2)
    _assert_trend(x, w1, w2, diff, up)


@pytest.mark.cuda
def test_cuda_fused_trend_bits_repeat(cuda):
    rng = np.random.default_rng(5)
    x = torch.from_numpy((100 + np.cumsum(rng.normal(0, 0.05, 1 << 20)))
                         .astype(np.float32)).to(cuda)
    d0, u0 = fq.fused_trend(x, 20, 50)
    for _ in range(5):
        d, u = fq.fused_trend(x, 20, 50)
        assert torch.equal(d.view(torch.int32), d0.view(torch.int32))
        assert torch.equal(u, u0)


# ---------------------------------------------------------------------------
# the runner on the card
# ---------------------------------------------------------------------------

# about 2 ms of a device sleep at the H100's clocks: longer than the host
# takes to issue one step of the recorder tests' runners
_SLEEP_CYCLES = 4_000_000


def _fraud_runners(keyed, n_keys, segs, out_len=64):
    q = streams.fraud_query(64, keyed=keyed).node
    kw = dict(n_keys=n_keys if keyed else None, segs_per_chunk=segs)
    keys = "vmapped" if keyed else "single"
    return (Runner(qc.compile_query(q, out_len=out_len),
                   ExecPolicy(keys=keys), **kw),
            Runner(qc.compile_query(q, out_len=out_len, sparse=True),
                   ExecPolicy(body="sparse", keys=keys), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["dense", "sparse"])
def test_cuda_recorded_chunks_on_the_host_clock(cuda, body):
    """The recorder's chunk events: one interval a step, in order, the
    gaps between them labelled, their mean device time that of CUDA events
    around the same steps, and no synchronizing call while recording.

    A device sleep queued before each step keeps the card behind the host,
    so the events around a step time the step's work on the card and not
    the card waiting for the host to issue it: that wait lies outside the
    chunk, in the idle gap before it."""
    n_keys, segs, n = 4096, 8, 24
    span = 64 * segs
    vals = streams.keyed_activity(n_keys, span * (n + 2), 0.1, 0)
    grids = [{"in": keyed_grid(vals[:, c * span:(c + 1) * span],
                               np.ones((n_keys, span), bool), t0=c * span)}
             for c in range(n + 2)]
    dense, sparse = _fraud_runners(True, n_keys, segs)
    r = dense if body == "dense" else sparse
    r.step(grids[0])
    r.step(grids[1])
    tr = r.metrics.tracer
    assert tr.span_report()["runner.capture"]["count"] == sum(
        tr.captures().values()) >= 1
    tr.start_recording(256, device=cuda)
    around = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for (a, b), g in zip(around, grids[2:]):
            torch.cuda._sleep(_SLEEP_CYCLES)
            a.record()
            r.step(g)
            b.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tr.stop_recording()
    chunks = tr.device_chunks()
    assert len(chunks) == n and tr.dropped == 0
    assert [c.chunk for c in chunks] == sorted({e.chunk
                                                for e in tr.events()})
    for c, d in zip(chunks, chunks[1:]):
        assert c.start_ns <= c.end_ns <= d.start_ns
    gaps = tr.idle_gaps()
    assert len(gaps) == n - 1
    assert all(g.end_ns >= g.start_ns and g.label for g in gaps)
    mean_ms = sum(c.end_ns - c.start_ns for c in chunks) / n / 1e6
    want_ms = sum(a.elapsed_time(b) for a, b in around) / n
    assert abs(mean_ms - want_ms) <= 0.05 * want_ms, (mean_ms, want_ms)
    # the anchor: an event recorded on the idle card lands on the host
    # clock within a millisecond of the host's read beside it
    torch.cuda.synchronize()
    e = torch.cuda.Event(enable_timing=True)
    h = time.perf_counter_ns()
    e.record()
    e.synchronize()
    assert abs(tr.on_host_clock(e) - h) < 1_000_000


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["dense", "sparse"])
def test_cuda_recording_across_the_captures(cuda, body):
    """The recorder on from a runner's first step, so each capture (the
    warm-up on a side stream, the record in global mode) runs inside
    ``runner.step/launch``, between its chunk's two events: the results
    are a plain runner's bit for bit, every chunk has its interval, and
    each capture is an event inside ``launch``."""
    n_keys, segs, n = 4096, 8, 6
    span = 64 * segs
    vals = streams.keyed_activity(n_keys, span * n, 0.1, 0)
    grids = [{"in": keyed_grid(vals[:, c * span:(c + 1) * span],
                               np.ones((n_keys, span), bool), t0=c * span)}
             for c in range(n)]
    pick = body == "sparse"
    r = _fraud_runners(True, n_keys, segs)[pick]
    plain = _fraud_runners(True, n_keys, segs)[pick]
    tr = r.metrics.tracer
    tr.start_recording(256, device=cuda)
    outs = [r.step(g) for g in grids]
    tr.stop_recording()
    for g, o in zip(grids, outs):
        want = plain.step(g)
        assert torch.equal(o.valid, want.valid)
        assert torch.equal(o.value[o.valid], want.value[want.valid])
    chunks = tr.device_chunks()
    assert len(chunks) == n and tr.dropped == 0
    for c, d in zip(chunks, chunks[1:]):
        assert c.start_ns <= c.end_ns <= d.start_ns
    caps = [e for e in tr.events() if e.path.endswith("runner.capture")]
    assert len(caps) == sum(tr.captures().values()) >= 1
    assert all(e.path == "runner.step/launch/runner.capture"
               for e in caps), caps
    assert len(tr.idle_gaps()) == n - 1


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
def test_cuda_steady_chunk_never_synchronizes(cuda, keyed):
    """A steady-state chunk is a graph replay: the sparse one picks its
    bucket on the device, so neither it nor a dense chunk makes a
    synchronizing call."""
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
    assert _count_syncs(lambda: sparse.step(chunks[2])) == 0
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


# ---------------------------------------------------------------------------
# the union runner and late-data revision on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("keyed", [False, True])
def test_cuda_union_session_dense_sparse_and_cpu(cuda, keyed):
    """Eight dashboard queries in one session: sparse ≡ dense bit for bit
    on the card, both through ``seg_dirty`` (sparse) and the window kernels,
    and within f32 rounding of the CPU."""
    from repro_torch.multiquery import MultiQuerySession
    n_keys, span, n_chunks = 32, 256, 5
    qs = apps.dashboard_queries(8, keyed=keyed)
    vals = (streams.keyed_activity(n_keys, span * n_chunks, 0.1, 3) if keyed
            else streams.burst_stream(span * n_chunks, 0.05, 3))
    ok = np.ones(vals.shape, bool)
    outs = {}
    for dev, sparse in ((cuda, False), (cuda, True), ("cpu", False)):
        sess = MultiQuerySession(span, n_keys=n_keys if keyed else None,
                                 sparse=sparse)
        for name, q in qs.items():
            sess.attach(name, q)
        n0 = (sc.launches["seg_dirty"], wr.launches["sliding_assoc"])
        outs[(str(dev), sparse)] = sess.run(
            {"in": keyed_grid(vals, ok, device=dev)}, n_chunks)
        if dev != "cpu":
            assert wr.launches["sliding_assoc"] > n0[1]
            assert (sc.launches["seg_dirty"] - n0[0]
                    == (n_chunks if sparse else 0))
    for name in qs:
        d, s = outs[("cuda", False)][name], outs[("cuda", True)][name]
        c = outs[("cpu", False)][name]
        assert torch.equal(d.valid, s.valid)
        assert torch.equal(d.value[d.valid], s.value[s.valid])
        both = c.valid & d.valid.cpu()
        assert float((c.value[both] - d.value.cpu()[both]).abs().max()) \
            <= 1e-2
        assert (c.valid != d.valid.cpu()).float().mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("keyed", [False, True])
def test_cuda_soe_session_matches_block_session(cuda, keyed):
    """A ``sum_algo="soe"`` session takes its window sums through
    ``prefix_scan``, the block one through ``sliding_assoc``; on integer
    prices in [0, 16) both sums are exact, so the two are bit for bit on
    the card, dense and sparse, and so are the CPU's mean-only heads; its
    stddev heads agree within 1e-4."""
    from repro_torch.multiquery import MultiQuerySession
    n_keys, span, n_chunks = 32, 256, 4
    qs = apps.dashboard_queries(8, keyed=keyed)
    rng = np.random.default_rng(11)
    shape = (n_keys, span * n_chunks) if keyed else (span * n_chunks,)
    vals = np.floor(rng.random(shape) * 16).astype(np.float32)
    ok = np.ones(shape, bool)
    outs = {}
    for dev, sparse, algo in ((cuda, False, "block"), (cuda, False, "soe"),
                              (cuda, True, "soe"), ("cpu", False, "soe")):
        sess = MultiQuerySession(span, n_keys=n_keys if keyed else None,
                                 sparse=sparse, sum_algo=algo)
        for name, q in qs.items():
            sess.attach(name, q)
        n0 = wr.launches["prefix_scan"]
        outs[(str(dev), sparse, algo)] = sess.run(
            {"in": keyed_grid(vals, ok, device=dev)}, n_chunks)
        if dev != "cpu":
            assert (wr.launches["prefix_scan"] > n0) == (algo == "soe")
    for name in qs:
        want = outs[("cuda", False, "block")][name]
        wm, wv = want.valid.cpu(), want.value.cpu()
        for k in (("cuda", False, "soe"), ("cuda", True, "soe"),
                  ("cpu", False, "soe")):
            got = outs[k][name]
            gm, gv = got.valid.cpu(), got.value.cpu()
            if k[0] == "cuda" or int(name[1:]) % 4 < 2:
                assert torch.equal(gm, wm), k
                assert torch.equal(gv[gm], wv[wm]), k
                continue
            # the stddev heads' sqrt and divisions on the CPU round an
            # ulp apart from the card's
            both = gm & wm
            assert float((gv[both] - wv[both]).abs().max()) <= 1e-4, k
            assert (wv[gm != wm].abs() <= 1e-4).all(), k


@pytest.mark.cuda
def test_cuda_revision_reads_nothing_from_the_card(cuda):
    """A runner with its revision ring on makes no host read per sparse
    chunk, as without it, and ``revise`` makes none: the mask is host data
    and reaches the card by an asynchronous copy, and its bucket's graph
    was captured ahead (a capture synchronizes; a replay does not)."""
    from repro_torch.core.sparse import retro_segment_mask
    segs, span = 4, 256
    vals = streams.burst_stream(4 * span, 0.05, 2)
    chunks = [{"in": keyed_grid(vals[c * span:(c + 1) * span],
                                np.ones(span, bool), t0=c * span)}
              for c in range(4)]
    _, r = _fraud_runners(False, 1, segs)
    r.enable_revision(4)
    for _label, key in r.aot_keys():
        if key[0] == "revise":
            assert r.install_executable(key, chunks=chunks[0]) == "captured"
    r.step(chunks[0])
    r.step(chunks[1])
    assert _count_syncs(lambda: r.step(chunks[2])) == 0
    r.step(chunks[3])
    cp = r.spec.change_plan
    sp = cp.specs["in"]
    t_patch = 2 * span + 6          # tick 5 of chunk 2
    masks = [retro_segment_mask(sp.lookback, sp.lookahead, sp.prec,
                                c * span, cp.out_prec, cp.out_len, segs,
                                [t_patch]) for c in (2, 3)]
    patched = [{"in": g["in"].replace(value=g["in"].value.clone())}
               for g in chunks[2:]]
    patched[0]["in"].value[5] += 1.0
    res = []
    assert _count_syncs(lambda: res.extend(r.revise(2, patched, masks))) \
        == 0
    snap = r.metrics.snapshot()["counters"]
    assert snap["runner.revision_units"]["value"] == sum(
        int(m.sum()) for m in masks)
    # the dirty segments equal a from-scratch sparse run on patched data
    _, fresh = _fraud_runners(False, 1, segs)
    full = np.concatenate([vals[:2 * span],
                           patched[0]["in"].value.cpu().numpy(),
                           vals[3 * span:]])
    want = fresh.run({"in": keyed_grid(full, np.ones(full.shape, bool))}, 4)
    for i, c in enumerate((2, 3)):
        tick = torch.from_numpy(np.repeat(masks[i], span // segs)).to(cuda)
        sl = slice(c * span, (c + 1) * span)
        gm = res[i].valid[tick]
        assert torch.equal(gm, want.valid[sl][tick])
        assert torch.equal(res[i].value[tick][gm], want.value[sl][tick][gm])


# ---------------------------------------------------------------------------
# captured steps: the card's graphs against the CPU's eager steps
# ---------------------------------------------------------------------------

def _int_vals(shape, seed, rate=0.05):
    """Piecewise-constant integer prices: exact in f32 in every order of
    summation, so card and CPU agree bit for bit."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    change = rng.random(shape) < rate
    change[..., 0] = True
    raw = np.floor(rng.random(shape) * 16).astype(np.float32)
    idx = np.maximum.accumulate(np.where(change, np.arange(n), -1), axis=-1)
    return np.take_along_axis(raw, idx, axis=-1)


def _same(a, b):
    a_m, b_m = a.valid.cpu(), b.valid.cpu()
    assert torch.equal(a_m, b_m)
    assert torch.equal(a.value.cpu()[a_m], b.value.cpu()[b_m])


def _mean_runners(keyed, n_keys, segs, out_len=64):
    """Dense and sparse runners of a short mean minus a long mean, gated
    on its sign: on integer data its sums are exact and its one division
    per mean is correctly rounded on both devices (the fraud query's
    stddev is not: its sqrt and divisions differ by an ulp between card
    and CPU)."""
    from repro_torch.core.frontend import TStream
    s = TStream.source("in", prec=1, keyed=keyed)
    q = (s.window(16).mean().join(s.window(64).mean(), lambda a, b: a - b)
         .where(lambda d: d > 0)).node
    kw = dict(n_keys=n_keys if keyed else None, segs_per_chunk=segs)
    keys = "vmapped" if keyed else "single"
    return (Runner(qc.compile_query(q, out_len=out_len),
                   ExecPolicy(keys=keys), **kw),
            Runner(qc.compile_query(q, out_len=out_len, sparse=True),
                   ExecPolicy(body="sparse", keys=keys), **kw))


@pytest.mark.cuda
def test_cuda_ysb_runner_sums_only_the_ticks_its_windows_read(cuda,
                                                             monkeypatch):
    """ysb at its benchmark cell's geometry (100 keys, 16 tumbling windows
    of 10000 ticks a chunk): the count's sliding sum runs over the 10000
    ticks a window reads, rows of (3200, 10000) (the value and the count
    channel of 1600 units), not over the halo; 8 chunks count exactly what
    a float64 count of the same views gives."""
    K, win, segs, n_chunks = 100, 10000, 16, 8
    span = win * segs
    seen, orig = {}, wr.sliding_assoc

    def record(x, window, op):
        key = (*x.shape, int(window), op)
        seen[key] = seen.get(key, 0) + 1
        return orig(x, window, op)

    monkeypatch.setattr(wr, "sliding_assoc", record)
    exe = qc.compile_query(apps.make_keyed_app("ysb", win=win).query.node, 1)
    r = Runner(exe, ExecPolicy(keys="vmapped"), n_keys=K,
               segs_per_chunk=segs)
    gauges = r.metrics.snapshot()["gauges"]
    assert gauges["runner.eval_trim_pct.in"]["value"] == 50.0
    gen = torch.Generator(device=cuda).manual_seed(29)
    ok = torch.ones((K, span), dtype=torch.bool, device=cuda)
    for c in range(n_chunks):
        etype = torch.randint(0, 3, (K, span), generator=gen,
                              device=cuda).float()
        out = r.step({"in": keyed_grid({"etype": etype}, ok, t0=c * span)})
        want = (etype == 1.0).double().reshape(K, segs, win).sum(-1)
        assert bool(out.valid.all())
        assert torch.equal(out.value.double(), want)
    assert list(seen) == [(3200, win, win, "add")], seen


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["dense", "sparse"])
@pytest.mark.parametrize("keyed", [False, True])
def test_cuda_captured_steps_equal_cpu_on_integer_data(cuda, body, keyed):
    """Every chunk on the card is a graph replay (captured at the first
    use of each variant); on integer data it equals the CPU's eager steps
    bit for bit, and the sparse body equals the dense one."""
    n_keys, segs, n_chunks = 24, 4, 6
    span = 64 * segs
    shape = (n_keys, span * n_chunks) if keyed else (span * n_chunks,)
    vals = _int_vals(shape, 5, rate=0.002)   # some segments stay clean
    ok = np.ones(shape, bool)
    dense, sparse = _mean_runners(keyed, n_keys, segs)
    r = sparse if body == "sparse" else dense
    got = r.run({"in": keyed_grid(vals, ok)}, n_chunks)
    caps = r.metrics.tracer.captures()
    assert caps and all(n == 1 for n in caps.values()), caps
    want = _mean_runners(keyed, n_keys, segs)[body == "sparse"].run(
        {"in": keyed_grid(vals, ok, device="cpu")}, n_chunks)
    _same(got, want)
    if body == "sparse":
        _same(got, dense.run({"in": keyed_grid(vals, ok)}, n_chunks))
        assert r.dirty_stats()["dirty_units"] < r.dirty_stats()["units"]


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_cuda_captured_union_session_equals_cpu(cuda, sparse):
    """A keyed union session's chunks are graph replays that equal the
    CPU's eager session bit for bit on integer prices (mean heads), with no
    capture after the first two chunks."""
    from repro_torch.multiquery import MultiQuerySession
    n_keys, span, n_chunks = 16, 256, 5
    qs = {k: q for k, q in apps.dashboard_queries(8, keyed=True).items()
          if int(k[1:]) % 4 < 2}
    vals = _int_vals((n_keys, span * n_chunks), 9)
    ok = np.ones(vals.shape, bool)
    outs = {}
    for dev in (cuda, "cpu"):
        sess = MultiQuerySession(span, n_keys=n_keys, sparse=sparse)
        for name, q in qs.items():
            sess.attach(name, q)
        g = {"in": keyed_grid(vals, ok, device=dev)}
        first = sess.run({"in": g["in"].replace(
            value=g["in"].value[:, :2 * span],
            valid=g["in"].valid[:, :2 * span])}, 2)
        before = dict(sess.metrics.tracer.captures())
        rest = sess.run({"in": g["in"].replace(
            value=g["in"].value[:, 2 * span:],
            valid=g["in"].valid[:, 2 * span:], t0=2 * span)}, n_chunks - 2)
        assert sess.metrics.tracer.captures() == before
        outs[str(dev)] = {q: (first[q], rest[q]) for q in qs}
    for q in qs:
        for a, b in zip(outs["cuda"][q], outs["cpu"][q]):
            _same(a, b)


@pytest.mark.cuda
def test_cuda_captured_revision_equals_cpu(cuda):
    """A revision on the card (one captured graph per bucket) returns the
    CPU's revision bit for bit on integer data, and both commit the same
    state: the next chunk agrees too."""
    from repro_torch.core.sparse import retro_segment_mask
    segs, span = 4, 256
    vals = _int_vals((5 * span,), 13)

    def chunks(dev):
        return [{"in": keyed_grid(vals[c * span:(c + 1) * span],
                                  np.ones(span, bool), t0=c * span,
                                  device=dev)} for c in range(5)]

    res = {}
    for dev in (cuda, "cpu"):
        cs = chunks(dev)
        _, r = _mean_runners(False, 1, segs)
        r.enable_revision(4)
        for c in cs[:4]:
            r.step(c)
        cp = r.spec.change_plan
        sp = cp.specs["in"]
        t_patch = 2 * span + 6
        masks = [retro_segment_mask(sp.lookback, sp.lookahead, sp.prec,
                                    c * span, cp.out_prec, cp.out_len, segs,
                                    [t_patch]) for c in (2, 3)]
        patched = [{"in": g["in"].replace(value=g["in"].value.clone())}
                   for g in cs[2:4]]
        patched[0]["in"].value[5] += 3.0
        rev = r.revise(2, patched, masks)
        nxt = r.step(cs[4])
        res[str(dev)] = (rev, masks, nxt)
    (rc, masks, nc), (rp, _, np_) = res["cuda"], res["cpu"]
    for i, m in enumerate(masks):
        tick = torch.from_numpy(np.repeat(m, span // segs))
        gm, wm = rc[i].valid.cpu()[tick], rp[i].valid[tick]
        assert torch.equal(gm, wm)
        assert torch.equal(rc[i].value.cpu()[tick][gm], rp[i].value[tick][wm])
    _same(nc, np_)


# ---------------------------------------------------------------------------
# serving on the card
# ---------------------------------------------------------------------------

def _serve_query():
    from repro_torch.core.frontend import TStream
    s = TStream.source("in", prec=1)
    mu = s.window(16).mean().shift(1)
    return s.join(mu, lambda x, m: x - m).where(lambda e: e > 0)


def _host_chunks(n, span, seed=3):
    from repro_torch.core.stream import SnapshotGrid
    rng = np.random.default_rng(seed)
    return [{"in": SnapshotGrid(
        value=rng.integers(0, 100, span).astype(np.float32),
        valid=np.ones(span, bool), t0=i * span, prec=1)} for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["dense", "sparse"])
def test_cuda_serve_steady_state_makes_no_synchronizing_call(cuda, tmp_path,
                                                             body):
    """A served runner captures every step while it warms up; serving host
    chunks then records no capture, its steady tail runs under PyTorch's
    sync debug mode set to raise, and the results are the CPU's bit for
    bit; a second service over the same cache directory starts warm."""
    from repro_torch.serve import build_service
    seg, spc, n = 32, 2, 8
    kw = dict(out_len=seg, segs_per_chunk=spc,
              policy=ExecPolicy(body=body), cache_dir=str(tmp_path))
    svc = build_service(_serve_query(), **kw)
    assert svc.plan_source == "cold"
    assert set(svc.aot_report.values()) == {"captured"}
    caps = svc.runner.metrics.tracer.captures()
    assert caps and all(c == 1 for c in caps.values())
    chunks = _host_chunks(n, seg * spc)
    gen = svc.serve(iter(chunks))
    outs = [next(gen), next(gen)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs += list(gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(outs) == n
    assert svc.runner.metrics.tracer.captures() == caps
    cpu = build_service(_serve_query(), device="cpu",
                        **dict(kw, cache_dir=None))
    for got, chunk in zip(outs, chunks):
        _same(got, cpu.step(chunk))
    snap = svc.runner.metrics.snapshot()
    assert snap["histograms"]["serve.call_seconds"]["count"] == n
    warm = build_service(_serve_query(), **kw)
    assert warm.plan_source == "warm"
    assert set(warm.aot_report.values()) == {"captured"}
    _same(warm.step(chunks[0]), outs[0])


# ---------------------------------------------------------------------------
# mesh placement on a 1-rank NCCL mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(cuda):
    """The 1-rank NCCL mesh ``make_local_mesh()`` starts on the card (a
    second card cannot join a one-card machine: NCCL refuses two ranks on
    one device)."""
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh()


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["dense", "sparse"])
@pytest.mark.parametrize("keyed", [False, True])
def test_cuda_mesh_runner_equals_local_without_syncs(nccl_mesh, body,
                                                      keyed):
    """``Runner(placement=mesh)`` on the card: every chunk a replay of the
    steps captured at their first use, the result gathered over NCCL after
    it; bit for bit the local runner's, and a steady chunk makes no
    synchronizing call and captures nothing."""
    from repro_torch.engine import mesh_placement
    n_keys, segs, n_chunks = 24, 4, 6
    span = 64 * segs
    shape = (n_keys, span * n_chunks) if keyed else (span * n_chunks,)
    vals = _int_vals(shape, 7, rate=0.002)
    g = {"in": keyed_grid(vals, np.ones(shape, bool))}
    local = _mean_runners(keyed, n_keys, segs)[body == "sparse"]
    mesh = Runner(local.spec, ExecPolicy(
        body=body, keys=local.policy.keys,
        placement=mesh_placement(nccl_mesh)),
        n_keys=n_keys if keyed else None, segs_per_chunk=segs)
    want = local.run(g, n_chunks)
    got = mesh.run(g, n_chunks - 1)
    caps = mesh.metrics.tracer.captures()
    assert caps and all(n == 1 for n in caps.values()), caps
    last = {"in": g["in"].replace(
        value=g["in"].value[..., -span:], valid=g["in"].valid[..., -span:],
        t0=(n_chunks - 1) * span)}
    tail = []
    assert _count_syncs(lambda: tail.append(mesh.step(last))) == 0
    assert mesh.metrics.tracer.captures() == caps
    _same(want, got.replace(
        value=torch.cat([got.value, tail[0].value], dim=-1),
        valid=torch.cat([got.valid, tail[0].valid], dim=-1)))


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_cuda_shard_map_run_on_one_rank(nccl_mesh, sparse):
    """``shard_map_run`` and ``shard_union_run`` on the 1-rank NCCL mesh
    equal ``partition_run`` and the union session bit for bit."""
    from repro_torch.core.frontend import TStream
    from repro_torch.multiquery import MultiQuerySession, shard_union_run
    n = 1 << 14
    vals = _int_vals((n,), 3, rate=0.01)
    g = {"in": keyed_grid(vals, np.ones(n, bool))}
    exe = qc.compile_query(streams.fraud_query(64).node, out_len=n,
                           sparse=sparse)
    _same(par.partition_run(exe, g, 0, 1),
          par.shard_map_run(exe, g, nccl_mesh))
    s = TStream.source("in", prec=1)
    qs = {"a": s.window(16).mean(), "b": s.window(200).max()}
    out = shard_union_run(qs, n, g, nccl_mesh)
    sess = MultiQuerySession(n)
    for name, q in qs.items():
        sess.attach(name, q)
    ref = sess.run(g, 1)
    for name in qs:
        _same(ref[name], out[name])


@pytest.mark.cuda
def test_cuda_keyed_engine_and_session_on_mesh(nccl_mesh):
    """``KeyedEngine(mesh=)`` and a sparse keyed session with ``mesh=`` on
    the card equal their local counterparts bit for bit."""
    from repro_torch.core.frontend import TStream
    from repro_torch.engine import KeyedEngine
    from repro_torch.multiquery import MultiQuerySession
    K, T, span = 32, 1024, 128
    vals = _int_vals((K, T), 9, rate=0.01)
    g = {"in": keyed_grid(vals, np.ones((K, T), bool))}
    s = TStream.source("in", prec=1, keyed=True)
    trend = (s.window(16).mean().join(s.window(64).mean(),
                                      lambda a, b: a - b)
             .where(lambda d: d > 0))
    exe = qc.compile_query(trend.node, out_len=span, sparse=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        _same(KeyedEngine(exe, n_keys=K, sparse=True).run(g, T // span),
              KeyedEngine(exe, n_keys=K, sparse=True,
                          mesh=nccl_mesh).run(g, T // span))
    outs = []
    for mesh in (None, nccl_mesh):
        sess = MultiQuerySession(span, n_keys=K, sparse=True, mesh=mesh)
        sess.attach("trend", trend)
        sess.attach("band", s.window(32).max().join(s, lambda h, x: h - x))
        outs.append(sess.run(g, T // span))
    for name in ("trend", "band"):
        _same(outs[0][name], outs[1][name])


# ---------------------------------------------------------------------------
# the static audit on the card (repro_torch.analysis)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("body", ["dense", "sparse"])
def test_cuda_transfer_pass_replay_finds_no_sync(cuda, body):
    """The transfer pass on a CUDA target records the chunk program on the
    card and replays one steady chunk of a twin under the sync debug mode
    set to raise: the shipped runner makes no synchronizing call and
    replays one graph; the host-read fixture is caught in the replay."""
    from repro_torch.analysis import make_target
    from repro_torch.analysis.passes import pass_transfers
    from repro_torch.engine import capture
    from test_torch_analysis import SPC, corpus_findings, trend_exe
    r = Runner(trend_exe(), ExecPolicy(body=body), segs_per_chunk=SPC)
    n0 = capture.replays["graph"]
    assert pass_transfers(make_target(r, device=cuda)) == []
    assert capture.replays["graph"] > n0
    hits = [f for f in corpus_findings("host_read", cuda, None)
            if f.code == "host-sync"]
    assert any(f.target == "steady (replayed)" for f in hits), hits


@pytest.mark.cuda
def test_cuda_collective_pass_flags_gather_in_body(nccl_mesh):
    """A gather inside a compacted body of a mesh runner on the 1-rank NCCL
    mesh fires the collective pass; the shipped runner at the point gives
    no error and warns only of its second graph."""
    from test_torch_analysis import corpus_findings, shipped_noise
    dev = torch.device("cuda")
    hits = [f for f in corpus_findings("body_gather", dev, nccl_mesh)
            if f.code == "collective-under-divergence"]
    assert hits and all("/body[" in f.provenance for f in hits)
    assert shipped_noise("body_gather", dev, nccl_mesh) == []


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["dense", "sparse"])
def test_cuda_serving_pass_certifies_service(cuda, tmp_path, body):
    """A ``build_service`` runner has every step captured ahead, its steady
    step writing its state in place: the serving pass certifies it."""
    from repro_torch.analysis import audit_runner
    from repro_torch.analysis.passes import pass_serving
    from repro_torch.serve import build_service
    seg, spc = 32, 2
    svc = build_service(_serve_query(), out_len=seg, segs_per_chunk=spc,
                        policy=ExecPolicy(body=body),
                        cache_dir=str(tmp_path))
    gen = svc.serve(iter(_host_chunks(4, seg * spc)))
    assert len(list(gen)) == 4
    findings = audit_runner(svc.runner, passes={"serving": pass_serving})
    assert [f.code for f in findings] == ["serving-aot-complete"], findings
    assert "(captured)" in findings[0].message


# ---------------------------------------------------------------------------
# LM serving: the decode step as one captured graph
# ---------------------------------------------------------------------------

LM_ARCHS = ["qwen3-1.7b", "gemma2-2b", "granite-moe-1b-a400m",
            "recurrentgemma-9b", "rwkv6-7b", "whisper-large-v3"]


def _lm_setup(arch, dev, cache_dtype=""):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              cache_dtype=cache_dtype)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(7))
    g = torch.Generator(device=dev).manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (2, 24), generator=g, device=dev)
    frames = (torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g,
                          device=dev) if cfg.family == "encdec" else None)
    return model, params, tokens, frames


def _lm_prefill(model, params, tokens, frames, prefill):
    if frames is not None:
        logits, caches, enc = prefill(params, tokens[:, :16], frames,
                                      max_len=24)
        return logits, caches, (enc,)
    logits, caches = prefill(params, tokens[:, :16], max_len=24)
    return logits, caches, ()


def _lm_cache_leaves(caches):
    from repro_torch.models.layers import KVCache
    out = []
    for st in caches:
        out += ([st.k, st.v, st.pos] if isinstance(st, KVCache)
                else list(st.values()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_decode_replays_with_no_sync(cuda, arch):
    """After its capture, a decode step (a replay, the argmax, the position
    advanced) makes no synchronizing call, and one (batch, max_len) keeps
    one graph."""
    from repro_torch.train import make_serve_steps
    model, params, tokens, frames = _lm_setup(arch, cuda)
    prefill_fn, decode_fn = make_serve_steps(model)
    _, caches, rest = _lm_prefill(model, params, tokens, frames, prefill_fn)
    pos = torch.full((), 16, dtype=torch.int32, device=cuda)
    tok = tokens[:, 16:17].clone()
    decode_fn(params, caches, tok, pos, *rest)      # captures
    torch.cuda.synchronize()

    def steps():
        for _ in range(4):
            logits, _ = decode_fn(params, caches, tok, pos, *rest)
            tok.copy_(torch.argmax(logits[:, 0], dim=-1)[:, None])
            pos.add_(1)

    assert _count_syncs(steps) == 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(decode_fn.graphs) == 1
    assert int(pos) == 24


@pytest.mark.cuda
@pytest.mark.parametrize("arch,cache_dtype",
                         [(a, "") for a in LM_ARCHS]
                         + [("qwen3-1.7b", "float8_e4m3fn")])
def test_cuda_lm_captured_decode_equals_eager(cuda, arch, cache_dtype):
    """The same prefill twice, then 6 teacher-forced decode steps: eager
    on one set of caches, replays of the captured graph on the other;
    logits and every cache buffer equal bit for bit."""
    from repro_torch.train import make_serve_steps
    model, params, tokens, frames = _lm_setup(arch, cuda, cache_dtype)
    prefill_fn, decode_fn = make_serve_steps(model)
    _, eager, rest_e = _lm_prefill(model, params, tokens, frames,
                                   model.prefill)
    _, graph, rest_g = _lm_prefill(model, params, tokens, frames, prefill_fn)
    for t in range(16, 22):
        le, _ = model.decode_step(params, eager, tokens[:, t:t + 1], t,
                                  *rest_e)
        lg, _ = decode_fn(params, graph, tokens[:, t:t + 1], t, *rest_g)
        assert torch.equal(le, lg), (arch, t)
    for a, b in zip(_lm_cache_leaves(eager), _lm_cache_leaves(graph)):
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a, b.view(torch.uint8)
                           if b.element_size() == 1 else b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_lm_logits_held_across_the_next_step(cuda, arch):
    """Logits a caller holds from decode step t are not overwritten by step
    t+1 (the graph's own logits are; a step returns a copy)."""
    from repro_torch.train import make_serve_steps
    model, params, tokens, frames = _lm_setup(arch, cuda)
    prefill_fn, decode_fn = make_serve_steps(model)
    _, caches, rest = _lm_prefill(model, params, tokens, frames, prefill_fn)
    held = []
    for t in range(16, 20):
        logits, caches = decode_fn(params, caches, tokens[:, t:t + 1], t,
                                   *rest)
        held.append((logits, logits.clone()))
    for logits, copy in held:
        assert torch.equal(logits, copy)
    assert not torch.equal(held[0][0], held[-1][0])


@pytest.mark.cuda
def test_cuda_lm_stale_caches_raise_and_graphs_stay_bounded(cuda):
    """Waves of one (batch, max_len) decode through one graph; caches a
    later prefill reset are refused."""
    from repro_torch.train import make_serve_steps
    model, params, tokens, frames = _lm_setup("qwen3-1.7b", cuda)
    prefill_fn, decode_fn = make_serve_steps(model)
    olds = []
    for _ in range(3):
        _, caches, rest = _lm_prefill(model, params, tokens, frames,
                                      prefill_fn)
        decode_fn(params, caches, tokens[:, 16:17], 16, *rest)
        olds.append(caches)
    assert len(decode_fn.graphs) == 1
    with pytest.raises(RuntimeError, match="stale caches"):
        decode_fn(params, olds[0], tokens[:, 17:18], 17)


def _kernels_in(fn) -> int:
    """Device kernels ``fn`` runs, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-large-v3"])
def test_cuda_lm_serving_is_the_same_whether_params_take_gradients(cuda,
                                                                    arch):
    """The serve steps run without gradients: the decode graph captured
    with the parameters taking gradients runs the same kernels and gives
    the same logits as the one captured without."""
    from repro_torch.train import make_serve_steps
    outs = []
    for grad in (False, True):
        model, params, tokens, frames = _lm_setup(arch, cuda)
        params.requires_grad_(grad)
        prefill_fn, decode_fn = make_serve_steps(model)
        _, caches, rest = _lm_prefill(model, params, tokens, frames,
                                      prefill_fn)
        step = lambda: decode_fn(params, caches, tokens[:, 16:17], 16,
                                 *rest)[0]
        step()
        _, caches, rest = _lm_prefill(model, params, tokens, frames,
                                      prefill_fn)
        logits = step()
        assert not logits.requires_grad
        outs.append((logits, _kernels_in(step)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1] > 0


# ---------------------------------------------------------------------------
# LM training: the train step as one captured graph
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["qwen3-1.7b", "gemma2-2b", "recurrentgemma-9b", "rwkv6-7b",
               "whisper-large-v3"]


def _train_setup(arch, dev, seed=7, **over):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import init_opt_state
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    return (model, params, init_opt_state(params),
            TokenPipeline(cfg, 2, 16, seed=3, device=dev))


def _train_leaves(params, opt):
    return ([p.detach() for p in params.parameters()]
            + list(opt["m"].values()) + list(opt["v"].values())
            + [opt["step"]])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_cuda_train_step_captured_equals_eager(cuda, arch):
    """Four steps from one state: eager on one copy, the captured step on
    the other (an eager first step and its capture, then three replays);
    losses, parameters, moments and the step count equal bit for bit (no
    MoE here: its dispatch backward adds with atomics, in any order)."""
    from repro_torch.train import AdamWConfig, make_train_step
    me, pe, oe, de = _train_setup(arch, cuda)
    mg, pg, og, dg = _train_setup(arch, cuda)
    cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    eager, captured = make_train_step(me, cfg), make_train_step(mg, cfg)
    for _ in range(4):
        _, _, m_e = eager.eager(pe, oe, de.next())
        _, _, m_g = captured(pg, og, dg.next())
        assert torch.equal(m_e["loss"], m_g["loss"])
        assert torch.equal(m_e["grad_norm"], m_g["grad_norm"])
    assert captured.captures == 1
    for a, b in zip(_train_leaves(pe, oe), _train_leaves(pg, og)):
        assert torch.equal(a, b)
    assert int(og["step"]) == 4


@pytest.mark.cuda
def test_cuda_train_step_holds_one_graph_across_states(cuda):
    """One train step over two states, A, A, B, B, A: each change of state
    captures anew and drops the graph before it (a state no one else
    holds is freed), and every state ends as its eager twin."""
    import gc
    import weakref
    from repro_torch.train import make_train_step
    model, pa, oa, da = _train_setup("qwen3-1.7b", cuda)
    _, pb, ob, db = _train_setup("qwen3-1.7b", cuda, seed=8)
    _, qa, ra, ea = _train_setup("qwen3-1.7b", cuda)
    _, qb, rb, eb = _train_setup("qwen3-1.7b", cuda, seed=8)
    step_fn, ref = make_train_step(model), make_train_step(model)
    for p, o, d, q, r, e in [(pa, oa, da, qa, ra, ea)] * 2 + [
            (pb, ob, db, qb, rb, eb)] * 2 + [(pa, oa, da, qa, ra, ea)]:
        got = step_fn(p, o, d.next())[2]["loss"]
        assert torch.equal(got, ref.eager(q, r, e.next())[2]["loss"])
    assert step_fn.captures == 3 and step_fn.graph[1] is pa
    assert all(torch.equal(x, y)
               for a, b in [((pa, oa), (qa, ra)), ((pb, ob), (qb, rb))]
               for x, y in zip(_train_leaves(*a), _train_leaves(*b)))
    gone = weakref.ref(pb)
    del pb, ob
    gc.collect()
    assert gone() is None


@pytest.mark.cuda
def test_cuda_train_step_replays_with_no_sync(cuda):
    """A steady train step (the next batch staged through pinned memory,
    one replay) makes no synchronizing call, and its metrics stay on the
    card."""
    from repro_torch.train import make_train_step
    model, params, opt, pipe = _train_setup("qwen3-1.7b", cuda)
    step_fn = make_train_step(model)
    step_fn(params, opt, pipe.next())
    step_fn(params, opt, pipe.next())
    torch.cuda.synchronize()
    metrics = []

    def steps():
        for _ in range(3):
            metrics.append(step_fn(params, opt, pipe.next())[2])

    assert _count_syncs(steps) == 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(m["loss"].device.type == "cuda" for m in metrics)
    assert all(np.isfinite(float(m["loss"])) for m in metrics)
    assert int(opt["step"]) == 8


@pytest.mark.cuda
def test_cuda_checkpoint_restored_into_a_captured_step_continues_it(cuda):
    """Six steps with a checkpoint after the third; the checkpoint
    restored into the live tensors, the captured step replays steps 4-6
    again with the same losses and ends in the same state, bit for
    bit."""
    import tempfile
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import make_train_step
    model, params, opt, pipe = _train_setup("qwen3-1.7b", cuda)
    step_fn = make_train_step(model)
    live = {"params": dict(params.named_parameters()), "opt": opt}
    losses = []
    with tempfile.TemporaryDirectory() as d:
        for i in range(6):
            losses.append(step_fn(params, opt, pipe.next())[2]["loss"])
            if i == 2:
                ck.save(d, 3, live, extra={"pipeline": pipe.state()})
        end = [t.clone() for t in _train_leaves(params, opt)]
        _, manifest = ck.restore(d, into=live)
    pipe.restore(manifest["extra"]["pipeline"])
    again = [step_fn(params, opt, pipe.next())[2]["loss"] for _ in range(3)]
    assert step_fn.captures == 1
    assert all(torch.equal(a, b) for a, b in zip(again, losses[3:]))
    assert all(torch.equal(a, b)
               for a, b in zip(_train_leaves(params, opt), end))


# ---------------------------------------------------------------------------
# the one-shot paths staged: one captured graph per geometry
# ---------------------------------------------------------------------------

def _launch_counts():
    return {**wr.launches, **sc.launches, **fq.launches}


def _launched(fn):
    """``fn()`` and the kernel launches it adds, by kernel."""
    before = _launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before.get(k, 0) for k, n in _launch_counts().items()
                 if n != before.get(k, 0)}


def _same_everywhere(a, b):
    """Two card grids equal at every tick, φ ticks and NaN included."""
    assert torch.equal(a.valid, b.valid)
    va, vb = (a.value, b.value) if isinstance(a.value, dict) else (
        {"v": a.value}, {"v": b.value})
    for k in va:
        assert torch.equal(va[k].isnan(), vb[k].isnan()), k
        assert torch.equal(va[k].nan_to_num(), vb[k].nan_to_num()), k


def _int_app_grids(app, n, seed, keys=None):
    data = (app.make_keyed_input(keys, n, seed) if keys
            else app.make_input(n, seed))
    for d in data.values():
        v = d["value"]
        d["value"] = ({k: np.floor(a) for k, a in v.items()}
                      if isinstance(v, dict) else np.floor(v))
    return apps.make_grids(data)


def _one_shot_cases():
    """``(label, staged call, eager call)`` of every staged entry point."""
    n, part = 1 << 16, 1 << 13
    out = []
    for name, algo in [(nm, "block") for nm in sorted(apps.APPS)] + [
            ("ysb", "soe"), ("resample", "soe")]:
        app = apps.make_app(name)
        g = _int_app_grids(app, n, 1)
        exe, eager = (qc.compile_query(app.query.node,
                                       out_len=part // app.query.prec,
                                       sum_algo=algo, jit=jit)
                      for jit in (True, False))
        k = n // part
        out.append((f"partition_run {name} {algo}",
                    lambda exe=exe, g=g, k=k: par.partition_run(exe, g, 0, k),
                    lambda e=eager, g=g, k=k: par.partition_run(e, g, 0, k)))
        if name in ("trend", "resample") and algo == "block":
            # one staged graph per node, a barrier after each
            out.append((f"interpreted {name}",
                        lambda exe=exe, g=g: par.partition_run(
                            exe, g, 0, 2, interpreted=True),
                        lambda e=eager, g=g: par.partition_run(
                            e, g, 0, 2, interpreted=True)))
    # windows under 8 ticks: the sum through prefix_scan, the min shifted
    # and combined in plain torch, both inside the capture
    from repro_torch.core.frontend import TStream
    s = TStream.source("in", prec=1)
    small = s.window(3).sum().join(s.window(5).min(), lambda a, b: a - b)
    g = {"in": keyed_grid(_int_vals((n,), 6), np.ones(n, bool))}
    exe, eager = (qc.compile_query(small.node, out_len=part, jit=jit)
                  for jit in (True, False))
    out.append(("partition_run windows under 8 ticks",
                lambda exe=exe, g=g: par.partition_run(exe, g, 0, n // part),
                lambda e=eager, g=g: par.partition_run(e, g, 0, n // part)))
    for name in sorted(apps.KEYED_APPS):
        app = apps.make_keyed_app(name)
        g = _int_app_grids(app, 1024, 2, keys=64)
        exe, eager = (qc.compile_query(app.query.node,
                                       out_len=1024 // app.query.prec,
                                       jit=jit) for jit in (True, False))
        out.append((f"batch_run {name}",
                    lambda exe=exe, g=g: par.batch_run(exe, g),
                    lambda e=eager, g=g: par.batch_run(e, g)))
    g = {"in": keyed_grid(_int_vals((n,), 5, rate=0.002),
                          np.ones(n, bool))}
    q = _mean_runners(False, 1, 1)[0].spec.root
    exe, eager = (qc.compile_query(q, out_len=512, sparse=True, opt=False,
                                   jit=jit) for jit in (True, False))
    for fused in (True, False):
        out.append((f"sparse_run fused={fused}",
                    lambda exe=exe, f=fused: sp.sparse_run(
                        exe, g, 0, n // 512, fused=f),
                    lambda e=eager, f=fused: sp.sparse_run(
                        e, g, 0, n // 512, fused=f)))
    return out


@pytest.mark.cuda
def test_cuda_staged_equals_eager_and_launches_as_it(cuda):
    """Every staged one-shot call (every app through ``partition_run``,
    both sum algorithms where they differ in kernels, two apps
    interpreted, the keyed apps through ``batch_run``, ``sparse_run``
    fused and not) equals
    ``jit=False`` bit for bit on integer data, and its steady call adds
    the launches the eager call does (a replay adds what its capture
    recorded)."""
    seen = set()
    for label, staged, eager in _one_shot_cases():
        staged()                                  # first use: capture
        eager()               # first use: the sparse hold seed's shapes
        got, n_staged = _launched(staged)
        want, n_eager = _launched(eager)
        _same_everywhere(got, want)
        assert n_staged == n_eager, (label, n_staged, n_eager)
        seen |= set(n_staged)
    # resample launches nothing (hold/linear interpolation and no window)
    assert seen == {"masked_rows", "sliding_assoc", "prefix_scan",
                    "seg_dirty"}, seen


@pytest.mark.cuda
def test_cuda_staged_steady_calls_read_nothing_and_replay_once(cuda):
    """After its first use, a ``partition_run`` is one graph replay per
    partition, a ``batch_run`` and a fused ``sparse_run`` one replay, and
    none of them makes a synchronizing call (the sparse one picks its
    bucket on the device and counts its dirty segments lazily)."""
    from repro_torch.engine import capture
    cases = {label: staged for label, staged, _ in _one_shot_cases()
             if "fused=False" not in label
             and not label.startswith("interpreted")}
    for label, staged in cases.items():
        staged()
        r0 = capture.replays["graph"]
        assert _count_syncs(staged) == 0, label
        replays = capture.replays["graph"] - r0
        parts = (1 << 16) // (1 << 13) if label.startswith("partition") \
            else 1
        assert replays == parts, (label, replays)


@pytest.mark.cuda
def test_cuda_sparse_run_counts_dirty_segments_on_the_card(cuda):
    """The fused run's dirty count reaches ``sparse.dirty_segments`` as a
    device tensor (read at snapshot), equal to the three-phase run's host
    count."""
    from repro_torch import obs
    n = 1 << 15
    g = {"in": keyed_grid(_int_vals((n,), 9, rate=0.003), np.ones(n, bool))}
    exe = qc.compile_query(streams.fraud_query(32).node, out_len=256,
                           sparse=True)
    sp.sparse_run(exe, g, 0, n // 256)
    deltas = []
    for fused in (True, False):
        s0 = obs.default().snapshot()
        sp.sparse_run(exe, g, 0, n // 256, fused=fused)
        deltas.append(obs.counter_delta(s0, obs.default().snapshot(),
                                        "sparse.dirty_segments"))
    assert deltas[0] == deltas[1] and 0 < deltas[0] < n // 256


@pytest.mark.cuda
def test_cuda_a_sync_in_a_map_function_raises_at_capture(cuda):
    """A user function that reads the card (``.item()``) runs in the eager
    warm-up, then fails the capture: the staged call raises, keeps no
    broken entry, and nothing runs eagerly in its place."""
    from repro_torch.core.frontend import TStream
    s = TStream.source("in", prec=1)
    q = s.window(8).sum().map(lambda v: v * float(v.max().item() > 0))
    exe = qc.compile_query(q.node, out_len=256)
    g = {"in": keyed_grid(_int_vals((1024,), 1), np.ones(1024, bool))}
    with pytest.raises(RuntimeError):
        par.partition_run(exe, g, 0, 4)
    assert not exe.fn.entries
    with pytest.raises(RuntimeError):
        par.partition_run(exe, g, 0, 4)
    eager = qc.compile_query(q.node, out_len=256, jit=False)
    assert par.partition_run(eager, g, 0, 4).valid.shape == (1024,)


@pytest.mark.cuda
def test_cuda_staged_lru_frees_and_rebuilds(cuda):
    """Past ``STAGED_CACHE_MAX`` geometries the least recently used entry
    goes with its graph; calling it again captures it anew, the same
    bits."""
    from repro_torch.engine import capture
    app = apps.make_keyed_app("trend")
    exe = qc.compile_query(app.query.node, out_len=256)
    grids = [_int_app_grids(app, 256, 3, keys=k)
             for k in range(1, capture.STAGED_CACHE_MAX + 2)]
    first = par.batch_run(exe, grids[0])
    for g in grids[1:]:
        par.batch_run(exe, g)
    step = exe._batch_stage                  # batch_run's own staging
    assert len(step.entries) == capture.STAGED_CACHE_MAX
    c0 = step.captures
    _same_everywhere(par.batch_run(exe, grids[0]), first)
    assert step.captures == c0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_cuda_staged_shard_paths_equal_eager(nccl_mesh, sparse):
    """``shard_map_run`` (dense, and sparse with its body picked from a
    device flag) staged on the 1-rank NCCL mesh: equal to ``jit=False``
    bit for bit; ``shard_union_run`` (always staged) equal to the union
    session bit for bit.  A steady call makes no synchronizing call and
    replays one graph."""
    from repro_torch.core.frontend import TStream
    from repro_torch.engine import capture
    from repro_torch.multiquery import MultiQuerySession, shard_union_run
    n = 1 << 14
    for rate in (0.0, 0.01):
        vals = _int_vals((n,), 3, rate=rate) if rate else np.full(
            n, 7.0, np.float32)
        g = {"in": keyed_grid(vals, np.ones(n, bool))}
        q = _mean_runners(False, 1, 1)[0].spec.root
        exe, eager = (qc.compile_query(q, out_len=n, sparse=sparse,
                                       opt=False, jit=jit)
                      for jit in (True, False))
        got = par.shard_map_run(exe, g, nccl_mesh)
        _same_everywhere(got, par.shard_map_run(eager, g, nccl_mesh))
        r0 = capture.replays["graph"]
        assert _count_syncs(lambda: par.shard_map_run(exe, g,
                                                      nccl_mesh)) == 0
        assert capture.replays["graph"] == r0 + 1
    s = TStream.source("in", prec=1)
    qs = {"a": s.window(16).mean(), "b": s.window(200).max()}
    out = shard_union_run(qs, n, g, nccl_mesh)
    sess = MultiQuerySession(n)
    for name, q in qs.items():
        sess.attach(name, q)
    ref = sess.run(g, 1)
    for name in qs:
        _same_everywhere(out[name], ref[name])
    r0 = capture.replays["graph"]
    assert _count_syncs(lambda: shard_union_run(qs, n, g, nccl_mesh)) == 0
    assert capture.replays["graph"] == r0 + 1


@pytest.mark.cuda
def test_cuda_staged_switch_writes_only_its_own_memory(cuda):
    """The tensors a composed graph writes outside its pool (the bodies'
    shared output) live as long as its entry: tensors allocated after the
    capture, of that size, keep their contents across replays."""
    from repro_torch.engine import capture
    n = 1 << 16
    sw = capture.StagedSwitch(
        lambda x: (x, (x > 0).sum(dtype=torch.int32)),
        [lambda x: x * 2, lambda x: x * 3],
        lambda out, count: out + 0, caps=[0, n])
    x = torch.ones(n, device=cuda)
    assert torch.equal(sw(x), x * 3)
    sentinels = [torch.full((n,), -7.0, device=cuda) for _ in range(64)]
    for _ in range(3):
        assert torch.equal(sw(x), x * 3)
        assert torch.equal(sw(x * 0), x * 0)
    torch.cuda.synchronize()
    assert all(bool((s == -7.0).all()) for s in sentinels)
