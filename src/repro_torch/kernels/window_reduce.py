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

Each wrapper dispatches on the tensor's device: a CPU tensor goes to the
plain version in :mod:`.ref`; a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches per wrapper (one per call that reached
the card).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import ref as _ref
from .build import launch_stream, library, padded

__all__ = ["prefix_scan", "prefix_plan", "PrefixPlan", "sliding_assoc",
           "sliding_regime", "sliding_plan", "SlidingPlan", "launches",
           "reset_launches", "COMBINES"]

# op name -> (plain combine, identity, kernel op code)
COMBINES = {
    "add": (torch.add, 0.0, 0),
    "max": (torch.maximum, -math.inf, 1),
    "min": (torch.minimum, math.inf, 2),
}

launches = {"prefix_scan": 0, "sliding_assoc": 0}

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


_lib = None
_plib = None


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


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
