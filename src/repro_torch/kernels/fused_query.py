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

Dispatch follows the tensor's device: a CPU tensor runs the plain version;
a CUDA tensor launches the kernel or raises.  ``launches["fused_trend"]``
counts kernel launches.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from .build import library

__all__ = ["fused_trend", "launches", "reset_launches"]

launches = {"fused_trend": 0}


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
    lib = library.load()
    if w2 > lib.ft_max_window():
        raise ValueError(f"fused_trend: w2={w2} exceeds "
                         f"{lib.ft_max_window()}")
    x = x.contiguous()
    T = x.shape[0]
    diff = torch.empty(T, dtype=torch.float32, device=x.device)
    up = torch.empty(T, dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ft_fused_trend(x.data_ptr(), diff.data_ptr(),
                                 up.data_ptr(), T, w1, w2, stream)
    if err != 0:
        raise RuntimeError(f"fused_trend: CUDA launch failed with error "
                           f"{err}")
    launches["fused_trend"] += 1
    return diff, up
