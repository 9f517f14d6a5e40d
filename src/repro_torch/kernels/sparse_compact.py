"""Fused change detection for sparse execution: the wrapper around the
CUDA kernel in ``csrc/sparse_compact.cu`` (port of
``repro.kernels.sparse_compact``).

Sparse execution resolves, per output segment, one bit: *did any input tick
in this segment's dilated lineage change?*  :func:`seg_dirty` answers it in
one launch per source: tick diff, ``ChangePlan`` dilation and per-segment
reduction, with the tick-level mask never in memory.  It replaces the
Pallas ``_kernel`` / ``_seg_dirty_pallas``
(``src/repro/kernels/sparse_compact.py:84-126``).

The reference packs each source into per-dtype channel matrices (value
leaves as rows, validity cast in as a row) because the TPU compares rows
vectorised within one dtype.  The CUDA kernel reads every row through its
own pointer, key stride and dtype instead, so :func:`grid_mats` returns
one matrix per value leaf and one for the validity mask, all views of the
grid's own tensors: nothing is stacked, padded or cast.  ORing the flags
of all rows is the same whichever matrix a row sits in, so the flags equal
the reference's.  The one copy the wrapper may make is of a matrix whose
time axis is not contiguous.

Launching is kept lean, since the runner calls it once per chunk and its
host time paced the chunk: the rows go to the kernel as one packed table
(:func:`pack_rows`), the grid comes from :func:`seg_dirty_plan` (a block
per unit for units wider than ``LONG_UNIT`` ticks, a warp per unit
below), and the stream is PyTorch's raw current stream; neither needs a
card to compute.

Dispatch follows the tensors' device: a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.seg_dirty_fused_ref`; a CUDA tensor launches
the kernel or raises.  ``launches["seg_dirty"]`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils._pytree import tree_leaves

from . import ref as _ref
from .build import launch_stream, library

__all__ = ["grid_mats", "seg_dirty", "seg_dirty_plan", "pack_rows",
           "launches", "reset_launches", "LONG_UNIT", "MAX_ROWS"]

launches = {"seg_dirty": 0}

# kernel dtype codes: value compare for f32/int32, byte compare for bool
_DTYPES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}

# as in csrc/sparse_compact.cu (checked against the library at first use)
LONG_UNIT = 256       # units wider than this many ticks get a block each
MAX_ROWS = 16         # rows one launch takes
_THREADS = 256
_WARPS = _THREADS // 32


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def grid_mats(value, valid) -> list:
    """One source grid's ``(value, valid)`` as channel matrices
    ``(..., C, T)`` for :func:`seg_dirty`: one per value leaf (a leaf with
    channel axes between the key axes and time keeps them as rows) and one
    for the validity mask, views of the grid's own tensors."""
    nd = valid.dim()
    mats = [leaf.unsqueeze(-2) if leaf.dim() == nd
            else leaf.flatten(nd - 1, -2) for leaf in tree_leaves(value)]
    return mats + [valid.unsqueeze(-2)]


def seg_dirty_plan(n_units: int, width: int):
    """``(threads per unit, blocks)`` of one launch over ``n_units`` units
    of ``width`` ticks: a block of ``_THREADS`` per unit wider than
    ``LONG_UNIT`` (so a few hundred long units fill the card), else a warp
    per unit, ``_WARPS`` units a block."""
    if width > LONG_UNIT:
        return _THREADS, n_units
    return 32, -(-n_units // _WARPS)


def pack_rows(xs):
    """The kernel's row table for ``(K, C, T)`` matrices ``xs`` whose time
    axis is contiguous, built in one step: three int64 words per channel
    (address of key 0, channel c, tick 0; elements between keys; dtype
    code), in order, as the ``ctypes`` array the kernel's ``Row``s are
    copied from."""
    words = []
    for x in xs:
        ptr, step = x.data_ptr(), x.element_size()
        ks, cs = x.stride()[:2]
        code = _DTYPES[x.dtype]
        for c in range(x.shape[1]):
            words += (ptr + c * cs * step, ks, code)
    return (ctypes.c_longlong * len(words))(*words)


_lib = None


def _seg_lib():
    global _lib
    if _lib is None:
        lib = library.load()
        if (lib.sd_max_rows(), lib.sd_threads()) != (MAX_ROWS, _THREADS):
            raise RuntimeError("seg_dirty: kernel geometry "
                               f"{(lib.sd_max_rows(), lib.sd_threads())} "
                               f"!= the wrapper's {(MAX_ROWS, _THREADS)}")
        _lib = lib
    return _lib


def seg_dirty(mats, geoms, n_segs: int) -> torch.Tensor:
    """Per-segment dirty flags ``(..., n_segs)`` bool: segment ``k`` is
    dirty iff any tick in ``[a0 + k·step, a0 + k·step + width)`` of any
    matrix differs from its predecessor tick (tick 0 and out-of-range ticks
    never count: carried flags are the caller's to OR in).

    ``mats``/``geoms`` are parallel lists: ``(..., C, T)`` channel matrices
    (:func:`grid_mats`; all with the same leading key axes) and their
    static ``(a0, step, width)`` lineage triples
    (:func:`repro_torch.core.plan.seg_range_affine`).  On CUDA the matrices
    sharing one triple and one ``T`` (one source) go to one launch (per
    ``MAX_ROWS`` rows); the kernel takes f32, int32 and bool matrices and
    raises on other dtypes.
    """
    first = mats[0]
    if not first.is_cuda and all(x.device.type == "cpu" for x in mats):
        return _ref.seg_dirty_fused_ref(mats, geoms, n_segs)
    dev = first.device
    lead = first.shape[:-2]
    K = lead[0] if len(lead) == 1 else math.prod(lead)
    groups: dict = {}
    for x, (a0, step, width) in zip(mats, geoms):
        if not x.is_cuda or x.device != dev:
            raise ValueError("seg_dirty: matrices must all lie on one CUDA "
                             "device, got "
                             f"{sorted({str(x.device) for x in mats})}")
        if x.shape[:-2] != lead:
            raise ValueError(f"seg_dirty: key axes {tuple(x.shape[:-2])} "
                             f"!= {tuple(lead)}")
        if x.dtype not in _DTYPES:
            raise TypeError(f"seg_dirty: dtype {x.dtype} not in "
                            f"{sorted(map(str, _DTYPES))}")
        if width <= 0:
            continue
        if x.dim() != 3:
            x = x.reshape((K,) + x.shape[-2:])
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            x = x.contiguous()
        groups.setdefault((a0, step, width, x.shape[-1]), []).append(x)
    # bool flags written as bytes 0/1 by the kernel
    alloc = torch.empty if groups else torch.zeros
    out = alloc((K, n_segs), dtype=torch.bool, device=dev)
    if groups:
        lib = _seg_lib()
        stream = launch_stream(dev)
        accumulate = 0
        for (a0, step, width, T), xs in groups.items():
            group, blocks = seg_dirty_plan(K * n_segs, width)
            table = pack_rows(xs)
            n = len(table) // 3
            for i in range(0, n, MAX_ROWS):
                part = (table if n <= MAX_ROWS else
                        (ctypes.c_longlong * (3 * min(MAX_ROWS, n - i)))(
                            *table[3 * i:3 * (i + MAX_ROWS)]))
                err = lib.sd_seg_dirty(
                    part, len(part) // 3, K, n_segs, int(a0), int(step),
                    int(width), T, out.data_ptr(), accumulate, group, blocks,
                    dev.index, stream)
                if err != 0:
                    raise RuntimeError(f"seg_dirty: CUDA launch failed with "
                                       f"error {err}")
                launches["seg_dirty"] += 1
                accumulate = 1
    return out if len(lead) == 1 else out.reshape(lead + (n_segs,))
