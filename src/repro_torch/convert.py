"""Carry grid data between the reference package and the port.

The data is what both packages must share (the counterpart of weights
carried across in a model port): :func:`to_grid` builds the port's
``SnapshotGrid`` on a device from a reference grid's arrays, copied through
numpy (a read-only view of a jax array never reaches ``torch``), and
:func:`to_numpy` brings a port grid back as numpy arrays.  Nothing here
imports the reference package: callers pass its arrays.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from .core.stream import SnapshotGrid
from .device import resolve

__all__ = ["to_grid", "to_numpy"]


def to_grid(value, valid, t0: int, prec: int, device=None) -> SnapshotGrid:
    """Port ``SnapshotGrid`` from a value pytree of arrays and a validity
    array (numpy, or anything ``np.array`` copies), with dtypes kept, on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    dev = resolve(device)

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return SnapshotGrid(value=tree_map(put, value), valid=put(valid),
                        t0=int(t0), prec=int(prec))


def to_numpy(grid: SnapshotGrid):
    """``(value, valid, t0, prec)`` of a port grid, as numpy arrays."""
    value = tree_map(lambda x: x.detach().cpu().numpy(), grid.value)
    return value, grid.valid.detach().cpu().numpy(), grid.t0, grid.prec
