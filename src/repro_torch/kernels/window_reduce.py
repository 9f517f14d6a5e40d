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
in no order, so ``prefix_scan`` becomes a tile-total pass plus a scan pass
whose blocks add the totals to their left, and ``sliding_assoc`` gives each
(row, group of stripes) its own block that walks its stripes in tiles with
carries (see the notes in the CUDA source).  Rows are independent, so a
leading key axis folds into R.

Each wrapper dispatches on the tensor's device: a CPU tensor goes to the
plain version in :mod:`.ref`; a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches per wrapper (one per call that reached
the card).
"""
from __future__ import annotations

import math

import torch

from . import ref as _ref
from .build import library

__all__ = ["prefix_scan", "sliding_assoc", "launches", "reset_launches",
           "COMBINES"]

# op name -> (plain combine, identity, kernel op code)
COMBINES = {
    "add": (torch.add, 0.0, 0),
    "max": (torch.maximum, -math.inf, 1),
    "min": (torch.minimum, math.inf, 2),
}

launches = {"prefix_scan": 0, "sliding_assoc": 0}

_MAX_BLOCKS = 2**31 - 1


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
    """Inclusive f32 prefix sum along the last axis of ``x: (R, T)``."""
    if x.device.type == "cpu":
        return _ref.prefix_sum_ref(x.float())
    _check(x, "prefix_scan", (torch.float32, torch.bfloat16))
    lib = library.load()
    R, T = x.shape
    out = torch.empty((R, T), dtype=torch.float32, device=x.device)
    if R == 0 or T == 0:
        return out
    nt = -(-T // lib.wr_tile())
    if R * nt > _MAX_BLOCKS:
        raise ValueError(f"prefix_scan: {R} x {nt} blocks exceed the grid")
    sums = torch.empty((R, nt), dtype=torch.float32, device=x.device)
    fn = (lib.wr_prefix_scan_f32 if x.dtype == torch.float32
          else lib.wr_prefix_scan_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(fn(x.data_ptr(), sums.data_ptr(), out.data_ptr(), R, T,
                     stream), "prefix_scan")
    launches["prefix_scan"] += 1
    return out


def sliding_assoc(x: torch.Tensor, window: int, op: str) -> torch.Tensor:
    """Sliding-window reduce along the last axis of ``x: (R, T)`` f32:
    ``out[:, t] = op over x[:, max(0, t-window+1) : t+1]``, ``op`` one of
    ``add``/``max``/``min``."""
    combine, identity, code = COMBINES[op]
    W = int(window)
    if x.device.type == "cpu":
        return _ref.sliding_assoc_block_ref(x, W, combine, identity)
    _check(x, "sliding_assoc", (torch.float32,))
    if W <= 1:
        return x
    lib = library.load()
    if W > lib.wr_max_window():
        raise ValueError(f"sliding_assoc: window {W} exceeds "
                         f"{lib.wr_max_window()}")
    R, T = x.shape
    out = torch.empty_like(x)
    if R == 0 or T == 0:
        return out
    tile = lib.wr_tile()
    per_block = W if W >= tile else (tile // W) * W
    if R * -(-T // per_block) > _MAX_BLOCKS:
        raise ValueError(f"sliding_assoc: ({R}, {T}) at W={W} exceeds the "
                         "grid")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(lib.wr_sliding_assoc_f32(x.data_ptr(), out.data_ptr(), R,
                                           T, W, code, stream),
                  "sliding_assoc")
    launches["sliding_assoc"] += 1
    return out
