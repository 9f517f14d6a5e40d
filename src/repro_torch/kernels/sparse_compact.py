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
from .build import library

__all__ = ["grid_mats", "seg_dirty", "launches", "reset_launches"]

launches = {"seg_dirty": 0}

# kernel dtype codes: value compare for f32/int32, byte compare for bool
_DTYPES = {torch.float32: 0, torch.int32: 1, torch.bool: 2}


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


def _launch(rows, K: int, n_segs: int, geom, T: int, out: torch.Tensor,
            accumulate: bool) -> None:
    lib = library.load()
    n = len(rows)
    ptrs = (ctypes.c_void_p * n)(*[r[0] for r in rows])
    kstrides = (ctypes.c_longlong * n)(*[r[1] for r in rows])
    dtypes = (ctypes.c_int * n)(*[r[2] for r in rows])
    a0, step, width = geom
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sd_seg_dirty(ptrs, kstrides, dtypes, n, K, n_segs,
                               int(a0), int(step), int(width), T,
                               out.data_ptr(), int(accumulate), stream)
    if err != 0:
        raise RuntimeError(f"seg_dirty: CUDA launch failed with error {err}")
    launches["seg_dirty"] += 1


def seg_dirty(mats, geoms, n_segs: int) -> torch.Tensor:
    """Per-segment dirty flags ``(..., n_segs)`` bool: segment ``k`` is
    dirty iff any tick in ``[a0 + k·step, a0 + k·step + width)`` of any
    matrix differs from its predecessor tick (tick 0 and out-of-range ticks
    never count: carried flags are the caller's to OR in).

    ``mats``/``geoms`` are parallel lists: ``(..., C, T)`` channel matrices
    (:func:`grid_mats`; all with the same leading key axes) and their
    static ``(a0, step, width)`` lineage triples
    (:func:`repro_torch.core.plan.seg_range_affine`).  On CUDA the matrices
    sharing one triple and one ``T`` (one source) go to one launch; the
    kernel takes f32, int32 and bool matrices and raises on other dtypes.
    """
    if all(x.device.type == "cpu" for x in mats):
        return _ref.seg_dirty_fused_ref(mats, geoms, n_segs)
    lead = mats[0].shape[:-2]
    K = math.prod(lead)
    dev = mats[0].device
    if dev.type != "cuda" or any(x.device != dev for x in mats):
        raise ValueError("seg_dirty: matrices must all lie on one CUDA "
                         f"device, got {sorted({str(x.device) for x in mats})}")
    groups: dict = {}
    for x, (a0, step, width) in zip(mats, geoms):
        if x.shape[:-2] != lead:
            raise ValueError(f"seg_dirty: key axes {tuple(x.shape[:-2])} "
                             f"!= {tuple(lead)}")
        if x.dtype not in _DTYPES:
            raise TypeError(f"seg_dirty: dtype {x.dtype} not in "
                            f"{sorted(map(str, _DTYPES))}")
        if width <= 0:
            continue
        x = x.reshape((K,) + x.shape[-2:])
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            x = x.contiguous()
        groups.setdefault((int(a0), int(step), int(width), x.shape[-1]),
                          []).append(x)
    alloc = torch.empty if groups else torch.zeros
    out = alloc((K, n_segs), dtype=torch.uint8, device=dev)
    max_rows = library.load().sd_max_rows()
    first = True
    for (a0, step, width, T), xs in groups.items():
        rows = [(x.data_ptr() + c * x.stride(1) * x.element_size(),
                 x.stride(0), _DTYPES[x.dtype])
                for x in xs for c in range(x.shape[1])]
        for i in range(0, len(rows), max_rows):
            _launch(rows[i:i + max_rows], K, n_segs, (a0, step, width), T,
                    out, accumulate=not first)
            first = False
    return out.view(torch.bool).reshape(lead + (n_segs,))
