"""The kernels' launch planning, which runs on the host and needs no card:
``window_reduce.sliding_plan`` (the regime of ``sliding_assoc`` and its
grid), ``window_reduce.prefix_plan`` (``prefix_scan``'s),
``fused_query.trend_plan`` (``fused_trend``'s),
``sparse_compact.seg_dirty_plan`` and ``sparse_compact.pack_rows`` (the
row table ``seg_dirty`` reads).  The geometry constants are held
against the CUDA sources they mirror.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import sparse_compact as sc
from repro_torch.kernels import window_reduce as wr

CSRC = Path(wr.__file__).resolve().with_name("csrc")
MAX_GRID = 2**31 - 1
STATIC_SMEM = 48 * 1024

# (R, T, W) of the main path: keyed runner chunk (65536 and 98304 rows of
# 129 ticks), single-stream runner chunk (512 and 768 rows of 577),
# one-shot partitions and keyed batches, the apps' windows
MAIN_PATH = [(65536, 129, 64), (98304, 129, 64), (512, 577, 64),
             (768, 577, 64), (2, 1048625, 50), (2, 1048576 + 49, 20),
             (8192, 4145, 50), (3, 100_003, 1000), (2, 5000, 3001),
             (32768, 193, 64)]


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def test_geometry_constants_match_the_cuda_sources():
    assert wr.SHORT_T == _constant("window_reduce.cu", "SHORT_T")
    assert wr.LONG_TILE == _constant("window_reduce.cu", "LTILE")
    assert sc.MAX_ROWS == _constant("sparse_compact.cu", "SD_MAX_ROWS")
    assert sc._THREADS == _constant("sparse_compact.cu", "SD_THREADS")


@pytest.mark.parametrize("T,W", [(1, 2), (31, 8), (129, 64), (577, 64),
                                 (1024, 50), (1024, 3000), (1025, 50),
                                 (1025, 2047), (1025, 2048), (4145, 50),
                                 (1 << 20, 3001)])
def test_regime_and_block_shape_depend_on_T_and_W_only(T, W):
    """Rows per block, stripes per block, block size and shared memory
    are the same for every row count: a row's bits cannot depend on how
    many rows share its launch."""
    plans = [wr.sliding_plan(R, T, W) for R in (1, 2, 7, 24, 1000, 98304)]
    assert {p.regime for p in plans} == {wr.sliding_regime(T, W)}
    assert len({(p.threads, p.param, p.smem) for p in plans}) == 1


@pytest.mark.parametrize("T,W,regime", [(1, 2, "short"), (1024, 2, "short"),
                                        (1024, 10**6, "short"),
                                        (1025, 2, "long"),
                                        (1025, 2047, "long"),
                                        (1025, 2048, "stripe"),
                                        (10**6, 50, "long")])
def test_regime_edges(T, W, regime):
    assert wr.SHORT_T == 1024 and wr.LONG_TILE == 2048
    assert wr.sliding_regime(T, W) == regime


@pytest.mark.parametrize("R,T,W", MAIN_PATH)
def test_sliding_grid_covers_the_rows_within_cuda_limits(R, T, W):
    p = wr.sliding_plan(R, T, W)
    assert 0 < p.blocks <= MAX_GRID
    assert p.threads % 32 == 0 and 32 <= p.threads <= 256
    if p.regime == "short":
        rpb = p.param
        assert rpb % (p.threads // 32) == 0 and p.blocks * rpb >= R
        assert (p.blocks - 1) * rpb < R
        # the staged rows (with the 16-byte cover) and one row of scratch
        # per warp fit the static limit, so no attribute is needed
        stage = -(-rpb * T // 4) * 4 + 4
        assert p.smem == 4 * (stage + (p.threads // 32) * T) <= STATIC_SMEM
    elif p.regime == "long":
        S = p.param
        assert S * W <= wr.LONG_TILE < (S + 1) * W
        groups = p.blocks // R
        assert groups * R == p.blocks and groups * S * W >= T
        assert (groups - 1) * S * W < T and p.smem == 0
    else:
        stripes = p.blocks // R
        assert stripes * R == p.blocks and stripes * W >= T
        assert p.smem == 4 * -(-W // wr.LONG_TILE)


def test_keyed_runner_shapes_pack_rows_per_block():
    """The keyed runner's 129-tick rows: several rows a warp, whole blocks
    of work, about R / rows-per-block blocks instead of one per row."""
    p = wr.sliding_plan(98304, 129, 64)
    assert p.regime == "short" and p.param >= 16
    assert p.blocks == -(-98304 // p.param)


@pytest.mark.parametrize("n_units,width,group,blocks", [
    (256, 577, 256, 256), (2048, 577, 256, 2048), (1, 257, 256, 1),
    (32768, 193, 32, 4096), (32768, 256, 32, 4096), (9, 64, 32, 2),
    (1, 1, 32, 1)])
def test_seg_dirty_plan(n_units, width, group, blocks):
    assert sc.seg_dirty_plan(n_units, width) == (group, blocks)
    per_block = 1 if group == 256 else 256 // group
    assert blocks * per_block >= n_units and blocks <= MAX_GRID


@pytest.mark.parametrize("dtype,code", [
    (torch.float32, 0), (torch.int32, 1), (torch.bool, 2), (torch.uint8, 2),
    (torch.int8, 2), (torch.float16, 3), (torch.bfloat16, 4),
    (torch.float64, 5), (torch.int64, 6), (torch.int16, 7)])
def test_pack_rows_encodes_pointer_stride_and_dtype(dtype, code):
    """One int64 row (address of key 0 of the channel at tick 0, elements
    between keys, dtype code) per channel: the kernel's Row layout."""
    base = torch.zeros(5, 3, 40, dtype=dtype)
    x = base[:, 1:, :]                     # a view: channels 1-2, stride
    packed = sc.pack_rows([x])
    assert ctypes.sizeof(packed) == 2 * 3 * 8      # 3 int64 words a row
    table = np.ctypeslib.as_array(packed).reshape(-1, 3)
    es = base.element_size()
    for c in range(2):
        assert table[c, 0] == base.data_ptr() + (1 + c) * 40 * es
        assert table[c, 1] == 3 * 40
        assert table[c, 2] == code


def test_dtype_codes_match_the_kernel_enum():
    """The wrapper's dtype codes are the .cu's ``enum Dtype``, and integer
    dtypes of one width share a code (compared by their bits)."""
    text = (CSRC / "sparse_compact.cu").read_text()
    body = re.search(r"enum Dtype \{(.*?)\};", text, re.S).group(1)
    enum = {n: int(v) for n, v in re.findall(r"(DT_\w+) = (\d+)", body)}
    names = {torch.float32: "DT_F32", torch.int32: "DT_I32",
             torch.bool: "DT_U8", torch.uint8: "DT_U8", torch.int8: "DT_U8",
             torch.float16: "DT_F16", torch.bfloat16: "DT_BF16",
             torch.float64: "DT_F64", torch.int64: "DT_I64",
             torch.int16: "DT_I16"}
    assert set(sc._DTYPES) == set(names)
    for dt, name in names.items():
        assert sc._DTYPES[dt] == enum[name], dt
    for dt, code in sc._DTYPES.items():
        same = [d for d, c in sc._DTYPES.items() if c == code]
        assert len({torch.empty(0, dtype=d).element_size()
                    for d in same}) == 1, same


def test_pack_rows_keeps_the_matrices_order():
    v = torch.zeros(4, 2, 10)
    m = torch.ones(4, 1, 10, dtype=torch.bool)
    table = np.ctypeslib.as_array(sc.pack_rows([v, m])).reshape(-1, 3)
    assert table[:, 2].tolist() == [0, 0, 2]
    assert table[:, 0].tolist() == [v.data_ptr(), v.data_ptr() + 40,
                                    m.data_ptr()]
    assert table[:, 1].tolist() == [20, 20, 10]
    # the kernel's Row is three 8-byte words, in this order
    text = (CSRC / "sparse_compact.cu").read_text()
    row = re.search(r"struct Row \{(.*?)\};", text, re.S).group(1)
    fields = re.findall(r"^\s*(.+?)\s+(\w+);", row, re.M)
    assert [(t, n) for t, n in fields] == [("const void*", "ptr"),
                                           ("long long", "kstride"),
                                           ("long long", "dtype")]


# ---------------------------------------------------------------------------
# prefix_scan and fused_trend
# ---------------------------------------------------------------------------

# (R, T) of prefix_scan: ysb's subtract-on-evict partitions (2 rows of a
# 2**20-tick partition plus halo), keyed batches, phase 2's shapes
PREFIX_SHAPES = [(2, (1 << 20) + 9), (2, (1 << 20) + 49), (8192, 4105),
                 (6, (1 << 20) + 49), (3, 1025), (1, 10), (3, 100_003),
                 (1, 1), (200, 8192), (5, 8193)]
SMEM_OPTIN = 232448


def test_prefix_and_trend_constants_match_the_cuda_sources():
    assert wr.PREFIX_ITEMS == _constant("window_reduce.cu", "PS_ITEMS")
    assert wr.PREFIX_THREADS == _constant("window_reduce.cu", "PS_THREADS")
    assert wr.PREFIX_TILE == wr.PREFIX_ITEMS * wr.PREFIX_THREADS
    assert "PS_TILE = PS_ITEMS * PS_THREADS;" in (
        CSRC / "window_reduce.cu").read_text()
    assert fq.FT_TILE == _constant("fused_query.cu", "FT_TILE")
    assert fq.FT_THREADS == _constant("fused_query.cu", "FT_THREADS")


@pytest.mark.parametrize("T", [1, 31, 512, 513, 4105, wr.PREFIX_TILE,
                               wr.PREFIX_TILE + 1, (1 << 20) + 9])
def test_prefix_plan_depends_on_T_only(T):
    """Regime, block size, tile length and shared memory are the same for
    every row count: a row's bits cannot depend on its neighbours."""
    plans = [wr.prefix_plan(R, T) for R in (1, 2, 7, 200, 8192)]
    assert len({(p.regime, p.threads, p.tiles, p.smem) for p in plans}) == 1
    assert plans[0].regime == ("short" if T <= wr.PREFIX_TILE else "long")


@pytest.mark.parametrize("R,T", PREFIX_SHAPES)
def test_prefix_grid_covers_every_row_and_tick(R, T):
    p = wr.prefix_plan(R, T)
    assert 0 < p.blocks <= MAX_GRID
    assert p.threads % 32 == 0 and 32 <= p.threads <= wr.PREFIX_THREADS
    # the staged tile (one pad word per 32) fits the static limit
    assert p.smem == 4 * (p.threads * wr.PREFIX_ITEMS
                          + p.threads * wr.PREFIX_ITEMS // 32 + 1)
    assert p.smem <= STATIC_SMEM
    if p.regime == "short":
        assert p.blocks == R and p.tiles == 1 and p.scratch == 0
        # the fewest whole warps that hold the row
        assert p.threads * wr.PREFIX_ITEMS >= T
        assert (p.threads - 32) * wr.PREFIX_ITEMS < T
    else:
        assert p.threads == wr.PREFIX_THREADS
        assert p.tiles * wr.PREFIX_TILE >= T > (p.tiles - 1) * wr.PREFIX_TILE
        assert p.blocks == R * p.tiles and p.scratch == 1 + p.blocks


def test_prefix_main_path_shapes_use_one_launch_of_few_blocks():
    """The one-shot partition's 2 rows: tiles of PREFIX_TILE, about two
    blocks an SM of the H100's 132; the keyed rows: a block each."""
    p = wr.prefix_plan(2, (1 << 20) + 9)
    assert p.regime == "long" and p.blocks == 2 * 129
    k = wr.prefix_plan(8192, 4105)
    assert k.regime == "short" and k.blocks == 8192 and k.threads == 288


@pytest.mark.parametrize("w2", [2, 3, 50, 64, 1000, 1025, 2047, 2048, 2049,
                                5000])
def test_trend_plan_depends_on_w2_only(w2):
    """Outputs per block are whole stripes, as many as fit FT_TILE (one
    stripe above it), for every T."""
    plans = [fq.trend_plan(T, w2) for T in (1, 49, 1001, 1 << 24)]
    assert len({(p.span, p.threads, p.smem) for p in plans}) == 1
    span = plans[0].span
    assert span % w2 == 0
    if w2 <= fq.FT_TILE:
        assert span <= fq.FT_TILE < span + w2
    else:
        assert span == w2


@pytest.mark.parametrize("T,w2", [(1 << 24, 50), (1 << 24, 20), (49, 50),
                                  (100_003, 64), (300_007, 2000),
                                  (50_000, 5000), (1, 2)])
def test_trend_grid_covers_every_tick_within_cuda_limits(T, w2):
    p = fq.trend_plan(T, w2)
    assert 0 < p.blocks <= MAX_GRID and p.threads == fq.FT_THREADS
    assert p.blocks * p.span >= T > (p.blocks - 1) * p.span
    # the staged ticks (the stripe before included) and the suffix sums,
    # padded to whole tiles
    L = -(-p.span // fq.FT_TILE) * fq.FT_TILE
    assert L - fq.FT_TILE < p.span <= L
    n = L + w2
    assert p.smem == 4 * (n + n // 32 + 1 + L + L // 32 + 1)
    if w2 <= fq.FT_TILE:
        assert p.smem <= STATIC_SMEM
