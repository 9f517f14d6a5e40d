"""Window-reduction kernels: wrappers around the CUDA sources in
``csrc/window_reduce.cu`` (port of ``repro.kernels.window_reduce``).

* :func:`prefix_scan` replaces the Pallas ``_prefix_scan_kernel``
  (``src/repro/kernels/window_reduce.py:53-87``): inclusive f32 prefix sum
  of ``(R, T)`` f32 or bf16 rows.
* :func:`sliding_assoc` replaces the Pallas ``_vanherk_kernel``
  (``src/repro/kernels/window_reduce.py:94-138``): the exact W-window
  add/max/min reduce of ``(R, T)`` f32 rows by Van Herk / Gil-Werman.

On the H100 both are bound by bytes: each reads its input once and writes
its output once (8 bytes per f32 element), against 3.35 TB/s.  The TPU
kernels carry state across a grid that runs in order; on Hopper blocks run
in no order, so ``prefix_scan`` is one launch with two regimes, chosen from
``T`` alone (:func:`prefix_plan`): a row of up to ``PREFIX_TILE`` elements
is one block's, a longer row is cut into tiles of ``PREFIX_TILE`` that
publish their totals and sum their predecessors' totals in a fixed order,
so the bits never depend on the blocks' timing.  ``sliding_assoc`` has three
launch regimes, chosen from ``(T, W)`` alone (:func:`sliding_regime`), so
a row's result never depends on how many rows share its launch: short
rows (``T <= SHORT_T``) one warp per row, rows staged per block; long rows
one block per (row, group of stripes) with one staged tile; stripes wider
than a tile walked tile by tile (see the notes in the CUDA source).
:func:`prefix_plan` and :func:`sliding_plan` compute the grids; they need
no card.  Rows are independent, so a leading key axis folds into R.

* :func:`masked_rows` (``csrc/masked_rows.cu``, no TPU counterpart: XLA
  fused the reference's mask into the kernel's input) writes the rows the
  other two read: the masked channels of a window reduction and its
  validity, ``(C + 1, R, T)`` f32, in one pass over its inputs at any row
  stride; :func:`masked_plan` picks its form and grid from the pointers
  and strides.

Each wrapper dispatches on the tensor's device: a CPU tensor goes to the
plain version in :mod:`.ref`; a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches per wrapper (one per call that reached
the card); ``copies`` counts the inputs ``masked_rows`` had to copy first.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import ref as _ref
from .build import launch_stream, library, padded

__all__ = ["prefix_scan", "prefix_plan", "PrefixPlan", "sliding_assoc",
           "sliding_regime", "sliding_plan", "SlidingPlan", "masked_rows",
           "masked_plan", "MaskedPlan", "launches", "copies",
           "reset_launches", "COMBINES"]

# op name -> (plain combine, identity, kernel op code)
COMBINES = {
    "add": (torch.add, 0.0, 0),
    "max": (torch.maximum, -math.inf, 1),
    "min": (torch.minimum, math.inf, 2),
}

launches = {"prefix_scan": 0, "sliding_assoc": 0, "masked_rows": 0}
# inputs a wrapper made f32 or contiguous before its launch
copies = {"masked_rows": 0}

_MAX_BLOCKS = 2**31 - 1

# The sliding kernel's geometry, as in csrc/window_reduce.cu (checked
# against the library when it is first used).
SHORT_T = 1024        # longest row of the short regime
LONG_TILE = 2048      # ticks per block tile in the long regimes
_THREADS = 256
_STAGE_FLOATS = 4096  # short regime: floats of rows one block stages
_REGIME_CODES = {"short": 0, "long": 1, "stripe": 2}

# The prefix kernel's geometry, as in csrc/window_reduce.cu.
PREFIX_ITEMS = 16     # elements a thread scans
PREFIX_THREADS = 512  # threads of a long row's tile
PREFIX_TILE = PREFIX_ITEMS * PREFIX_THREADS  # longest short row; long tile
_PREFIX_CODES = {"short": 0, "long": 1}

# The masked-rows kernel's geometry, as in csrc/masked_rows.cu.
MASKED_TILE = 1024    # ticks of a row a block writes
MASKED_MAX_CH = 4     # channels a launch
_MAX_GRID_Y = 65535


class PrefixPlan(NamedTuple):
    """One ``prefix_scan`` launch: regime, grid, block size, tiles per row,
    dynamic shared memory in bytes, and the int64 scratch words (the tile
    counter and one status word per tile; 0 for short rows)."""
    regime: str
    blocks: int
    threads: int
    tiles: int
    smem: int
    scratch: int


@functools.lru_cache(maxsize=256)
def prefix_plan(R: int, T: int) -> PrefixPlan:
    """The grid of ``prefix_scan`` over ``(R, T)`` rows, ``T >= 1``.

    * short (``T <= PREFIX_TILE``): one block per row, ``PREFIX_ITEMS``
      elements a thread, the fewest whole warps that hold the row.
    * long: ``ceil(T / PREFIX_TILE)`` tiles per row, one block of
      ``PREFIX_THREADS`` each.

    Everything but the grid and the scratch is a function of ``T`` alone,
    so a row's bits never depend on how many rows share its launch.
    """
    if T <= PREFIX_TILE:
        threads = 32 * -(-T // (32 * PREFIX_ITEMS))
        return PrefixPlan("short", R, threads, 1,
                          4 * padded(threads * PREFIX_ITEMS), 0)
    tiles = -(-T // PREFIX_TILE)
    return PrefixPlan("long", R * tiles, PREFIX_THREADS, tiles,
                      4 * padded(PREFIX_TILE), 1 + R * tiles)


class SlidingPlan(NamedTuple):
    """One ``sliding_assoc`` launch: regime, grid, block size, the
    regime's parameter (rows per block, stripes per block, or 0) and the
    dynamic shared memory in bytes."""
    regime: str
    blocks: int
    threads: int
    param: int
    smem: int


def sliding_regime(T: int, W: int) -> str:
    """The launch regime for rows of ``T`` ticks at window ``W``: a
    function of ``(T, W)`` only, never of the row count, so a row's bits do
    not depend on which rows share its launch."""
    if T <= SHORT_T:
        return "short"
    return "long" if W < LONG_TILE else "stripe"


@functools.lru_cache(maxsize=256)
def sliding_plan(R: int, T: int, W: int) -> SlidingPlan:
    """The grid of ``sliding_assoc`` over ``(R, T)`` rows at window ``W``.

    * short: one warp per row, 8 warps a block up to 256 ticks and 4
      above, each warp taking up to 4 rows so that a block stages about
      ``_STAGE_FLOATS`` floats; rows per block depend on ``T`` only.
    * long (``W < LONG_TILE``): one block per (row, group of
      ``LONG_TILE // W`` stripes).
    * stripe: one block per (row, stripe), with one carry per tile of the
      stripe in shared memory.
    """
    regime = sliding_regime(T, W)
    if regime == "short":
        warps = 8 if T <= 256 else 4
        rpb = warps * min(4, max(1, _STAGE_FLOATS // (T * warps)))
        stage = -(-rpb * T // 4) * 4 + 4
        return SlidingPlan(regime, -(-R // rpb), 32 * warps, rpb,
                           4 * (stage + warps * T))
    if regime == "long":
        S = LONG_TILE // W
        return SlidingPlan(regime, R * -(-T // (S * W)), _THREADS, S, 0)
    return SlidingPlan(regime, R * -(-T // W), _THREADS, 0,
                       4 * -(-W // LONG_TILE))


class MaskedPlan(NamedTuple):
    """One ``masked_rows`` launch: the vector form or the scalar one, the
    rows and ticks a row as launched, and the grid."""
    vec: bool
    rows: int
    ticks: int
    blocks_x: int
    blocks_y: int


def masked_plan(R: int, T: int, x_addrs, x_strides, v_addr: int,
                v_stride: int) -> MaskedPlan:
    """The launch of ``masked_rows`` over ``(R, T)`` rows, ``R, T >= 1``,
    of channels at byte addresses ``x_addrs`` with row strides
    ``x_strides`` (floats) and a validity at ``v_addr`` with row stride
    ``v_stride`` (bytes), every row's ticks contiguous.

    Inputs whose rows follow one another (every stride ``T``) are one run
    each and launch as one row of ``R * T`` ticks.  The vector form moves
    four ticks a thread in 16-byte accesses: it needs a multiple of 4 ticks
    a launched row and every input row 16-byte aligned (4-byte for the
    validity's bytes); anything else takes the scalar form.
    """
    if all(s == T for s in (*x_strides, v_stride)):
        R, T = 1, R * T
    vec = (T % 4 == 0 and v_addr % 4 == 0
           and all(a % 16 == 0 for a in x_addrs)
           and (R == 1 or (v_stride % 4 == 0
                           and all(s % 4 == 0 for s in x_strides))))
    return MaskedPlan(vec, R, T, -(-T // MASKED_TILE), min(R, _MAX_GRID_Y))


_lib = None
_plib = None
_mlib = None


def _prefix_lib():
    """The kernel library, its prefix tile checked against this module's
    at the first call."""
    global _plib
    if _plib is None:
        lib = library.load()
        if lib.wr_prefix_tile() != PREFIX_TILE:
            raise RuntimeError(f"prefix_scan: kernel tile "
                               f"{lib.wr_prefix_tile()} != the wrapper's "
                               f"{PREFIX_TILE}")
        _plib = lib
    return _plib


def _sliding_lib():
    """The kernel library and its largest window, the geometry checked
    against this module's at the first call."""
    global _lib
    if _lib is None:
        lib = library.load()
        if (lib.wr_short_t(), lib.wr_long_tile()) != (SHORT_T, LONG_TILE):
            raise RuntimeError("sliding_assoc: kernel geometry "
                               f"{(lib.wr_short_t(), lib.wr_long_tile())} "
                               f"!= the wrapper's {(SHORT_T, LONG_TILE)}")
        _lib = lib, lib.wr_max_window()
    return _lib


def _masked_lib():
    """The kernel library, its masked-rows geometry checked against this
    module's at the first call."""
    global _mlib
    if _mlib is None:
        lib = library.load()
        got = (lib.mr_tile(), lib.mr_max_channels())
        if got != (MASKED_TILE, MASKED_MAX_CH):
            raise RuntimeError(f"masked_rows: kernel geometry {got} != the "
                               f"wrapper's {(MASKED_TILE, MASKED_MAX_CH)}")
        _mlib = lib
    return _mlib


def reset_launches() -> None:
    """Zero ``launches`` and ``copies``."""
    for counts in (launches, copies):
        for k in counts:
            counts[k] = 0


def _check(x: torch.Tensor, name: str, dtypes) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not in {dtypes}")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected (R, T), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def prefix_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last axis of ``x: (R, T)``.

    On the card the long regime's scratch (:class:`PrefixPlan`) rides in
    front of the output in one allocation: the result is a view into it.
    """
    if x.device.type == "cpu":
        return _ref.prefix_sum_ref(x.float())
    _check(x, "prefix_scan", (torch.float32, torch.bfloat16))
    R, T = x.shape
    if R == 0 or T == 0:
        return torch.empty((R, T), dtype=torch.float32, device=x.device)
    plan = prefix_plan(R, T)
    if plan.blocks > _MAX_BLOCKS:
        raise ValueError(f"prefix_scan: ({R}, {T}) exceeds the grid")
    dev = x.device
    # int64 scratch words as f32 pairs, rounded so the output stays
    # 16-byte aligned
    front = -(-2 * plan.scratch // 4) * 4
    buf = torch.empty(front + R * T, dtype=torch.float32, device=dev)
    out = buf[front:].view(R, T) if front else buf.view(R, T)
    _raise_on(_prefix_lib().wr_prefix_scan(
        x.data_ptr(), out.data_ptr(), buf.data_ptr() if front else None, R,
        T, x.dtype == torch.bfloat16, _PREFIX_CODES[plan.regime],
        plan.blocks, plan.threads, plan.tiles, plan.smem, dev.index,
        launch_stream(dev)), "prefix_scan")
    launches["prefix_scan"] += 1
    return out


def sliding_assoc(x: torch.Tensor, window: int, op: str) -> torch.Tensor:
    """Sliding-window reduce along the last axis of ``x: (R, T)`` f32:
    ``out[:, t] = op over x[:, max(0, t-window+1) : t+1]``, ``op`` one of
    ``add``/``max``/``min``."""
    combine, identity, code = COMBINES[op]
    W = int(window)
    if not x.is_cuda and x.device.type == "cpu":
        return _ref.sliding_assoc_block_ref(x, W, combine, identity)
    _check(x, "sliding_assoc", (torch.float32,))
    if W <= 1:
        return x
    lib, max_w = _sliding_lib()
    if W > max_w:
        raise ValueError(f"sliding_assoc: window {W} exceeds {max_w}")
    R, T = x.shape
    out = torch.empty_like(x)
    if R == 0 or T == 0:
        return out
    plan = sliding_plan(R, T, W)
    if plan.blocks > _MAX_BLOCKS:
        raise ValueError(f"sliding_assoc: ({R}, {T}) at W={W} exceeds the "
                         "grid")
    dev = x.device
    _raise_on(lib.wr_sliding_assoc_f32(
        x.data_ptr(), out.data_ptr(), R, T, W, code,
        _REGIME_CODES[plan.regime], plan.blocks, plan.threads, plan.param,
        plan.smem, dev.index, launch_stream(dev)), "sliding_assoc")
    launches["sliding_assoc"] += 1
    return out


def _as_rows(t: torch.Tensor, dtype, R: int, T: int) -> torch.Tensor:
    """``t`` as ``(R, T)`` rows of ``dtype`` with contiguous ticks: a view
    where there is one, else a copy, counted."""
    if t.dtype == dtype and (T == 1 or t.stride(-1) == 1):
        try:
            return t.view(R, T)
        except RuntimeError:    # the leading axes do not fold into rows
            pass
    copies["masked_rows"] += 1
    rows = torch.empty(t.shape, dtype=dtype, device=t.device)
    rows.copy_(t)
    return rows.view(R, T)


def masked_rows(chans, valid: torch.Tensor, op: str) -> torch.Tensor:
    """The rows a window kernel reads: ``(C + 1, *B, T)`` f32, channel ``c``
    the channel ``chans[c]`` where ``valid`` holds and ``op``'s identity
    (0 for ``add``) elsewhere, channel ``C`` the validity as 1/0 (``-1/-0``
    for ``min``, whose any-valid row rides through the min combine).

    ``chans``: ``C`` channels ``(*B, T)``; ``valid``: ``(*B, T)`` bool;
    they broadcast.  On the card one launch reads each channel and the
    validity once, in place at any row stride; an input that is not f32 or
    whose ticks are not contiguous is copied first, and counted in
    ``copies``.  At most ``MASKED_MAX_CH`` channels.
    """
    code = COMBINES[op][2]
    dev = valid.device
    if dev.type == "cpu":
        return _ref.masked_rows_ref(chans, valid, op)
    if dev.type != "cuda" or any(c.device != dev for c in chans):
        raise ValueError(f"masked_rows: kernel takes CUDA tensors on one "
                         f"device, got {[c.device for c in chans]}, {dev}")
    if valid.dtype != torch.bool:
        raise TypeError(f"masked_rows: validity dtype {valid.dtype} is not "
                        "bool")
    C = len(chans)
    if C > MASKED_MAX_CH:
        raise ValueError(f"masked_rows: {C} channels, at most "
                         f"{MASKED_MAX_CH} a launch")
    # expanded views (torch.broadcast_shapes would import sympy at its
    # first call, seconds of set-up)
    valid, *chans = torch.broadcast_tensors(valid, *chans)
    shape = valid.shape
    if C == 0 or not shape:
        raise ValueError(f"masked_rows: expected channels (*B, T), got {C} "
                         f"of shape {tuple(shape)}")
    out = torch.empty((C + 1,) + shape, dtype=torch.float32, device=dev)
    T = shape[-1]
    R = math.prod(shape[:-1])
    if R == 0 or T == 0:
        return out
    v = _as_rows(valid, torch.bool, R, T)
    xs = [_as_rows(c, torch.float32, R, T) for c in chans]
    plan = masked_plan(R, T, [x.data_ptr() for x in xs],
                       [x.stride(0) for x in xs], v.data_ptr(), v.stride(0))
    if plan.blocks_x > _MAX_BLOCKS:
        raise ValueError(f"masked_rows: ({R}, {T}) exceeds the grid")
    lib = _masked_lib()
    rows = out.view(C + 1, R * T)
    _raise_on(lib.mr_masked_rows(
        (ctypes.c_void_p * C)(*(x.data_ptr() for x in xs)),
        (ctypes.c_longlong * C)(*(x.stride(0) for x in xs)), C,
        v.data_ptr(), v.stride(0), rows[0].data_ptr(), rows[C].data_ptr(),
        R * T, plan.rows, plan.ticks, code, int(plan.vec), plan.blocks_x,
        plan.blocks_y, dev.index, launch_stream(dev)), "masked_rows")
    launches["masked_rows"] += 1
    return out
