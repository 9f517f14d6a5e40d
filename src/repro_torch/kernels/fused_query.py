"""The whole stock-trend query as one kernel: the wrapper around
``csrc/fused_query.cu`` (port of ``repro.kernels.fused_query``).

:func:`fused_trend` computes, for a dense ``(T,)`` stream, ``diff =
mean_w1 - mean_w2`` of two trailing windows (each divided by ``min(pos+1,
w)``) and ``uptrend = diff > 0``.  It replaces the Pallas ``_kernel``
(``src/repro/kernels/fused_query.py:30-89``), with the same stripe
formulation (see the CUDA source and
:func:`repro_torch.kernels.ref.fused_trend_block_ref`, its plain
version).  Like the reference kernel it has no caller on the query path:
the trend app runs through the evaluator.

A block owns whole stripes, about ``FT_TILE`` outputs (one stripe when
``w2 > FT_TILE``), and stages the ticks it needs once
(:func:`trend_plan`, a function of ``w2``; it needs no card).  The
launch is lean, as the other wrappers': raw stream, the device set by
the C entry.

Dispatch follows the tensor's device: a CPU tensor runs the plain version;
a CUDA tensor launches the kernel or raises.  ``launches["fused_trend"]``
counts kernel launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import ref as _ref
from .build import launch_stream, library, padded

__all__ = ["fused_trend", "trend_plan", "TrendPlan", "launches",
           "reset_launches", "FT_TILE"]

launches = {"fused_trend": 0}

# as in csrc/fused_query.cu (checked against the library at first use)
FT_TILE = 2048        # ticks one block scan covers, 8 a thread
FT_THREADS = 256
_MAX_BLOCKS = 2**31 - 1


class TrendPlan(NamedTuple):
    """One ``fused_trend`` launch: outputs per block (whole stripes),
    blocks, threads and dynamic shared memory in bytes."""
    span: int
    blocks: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=64)
def trend_plan(T: int, w2: int) -> TrendPlan:
    """The grid of ``fused_trend`` over ``T`` ticks at long window ``w2``:
    ``FT_TILE // w2`` stripes of outputs a block, or one when ``w2 >
    FT_TILE``; shared memory for the stripe before them and their ticks,
    padded to whole tiles of ``FT_TILE``, and for the suffix sums."""
    span = (FT_TILE // w2) * w2 if w2 <= FT_TILE else w2
    tiles = -(-span // FT_TILE) * FT_TILE
    return TrendPlan(span, -(-T // span), FT_THREADS,
                     4 * (padded(tiles + w2) + padded(tiles)))


_lib = None


def _trend_lib():
    """The kernel library and its largest ``w2``, the tile checked
    against this module's at the first call."""
    global _lib
    if _lib is None:
        lib = library.load()
        if lib.ft_tile() != FT_TILE:
            raise RuntimeError(f"fused_trend: kernel tile {lib.ft_tile()} "
                               f"!= the wrapper's {FT_TILE}")
        _lib = lib, lib.ft_max_window()
    return _lib


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def fused_trend(x: torch.Tensor, w1: int, w2: int):
    """``x: (T,)`` dense stream (cast to f32).  Returns ``(diff (T,) f32,
    uptrend (T,) bool)``; ``w1 < w2``."""
    w1, w2 = int(w1), int(w2)
    if not 1 <= w1 < w2:
        raise ValueError(f"fused_trend: need 1 <= w1 < w2, got {w1}, {w2}")
    if x.dim() != 1:
        raise ValueError(f"fused_trend: expected (T,), got {tuple(x.shape)}")
    x = x.float()
    if x.device.type == "cpu":
        return _ref.fused_trend_block_ref(x, w1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_trend: kernel takes CUDA tensors, got "
                         f"{x.device}")
    lib, max_w = _trend_lib()
    if w2 > max_w:
        raise ValueError(f"fused_trend: w2={w2} exceeds {max_w}")
    x = x.contiguous()
    T = x.shape[0]
    dev = x.device
    diff = torch.empty(T, dtype=torch.float32, device=dev)
    up = torch.empty(T, dtype=torch.bool, device=dev)
    if T == 0:
        return diff, up
    plan = trend_plan(T, w2)
    if plan.blocks > _MAX_BLOCKS:
        raise ValueError(f"fused_trend: {T} ticks exceed the grid")
    err = lib.ft_fused_trend(x.data_ptr(), diff.data_ptr(), up.data_ptr(), T,
                             w1, w2, plan.span, plan.blocks, plan.smem,
                             dev.index, launch_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_trend: CUDA launch failed with error "
                           f"{err}")
    launches["fused_trend"] += 1
    return diff, up
