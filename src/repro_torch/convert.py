"""Carry grid data and stream state between the reference package and the
port.

The data is what both packages must share (the counterpart of weights
carried across in a model port): :func:`to_grid` builds the port's
``SnapshotGrid`` on a device from a reference grid's arrays, copied through
numpy (a read-only view of a jax array never reaches ``torch``), and
:func:`to_numpy` brings a port grid back as numpy arrays.

The carried state of a chunked run — a runner's or a session's
``state()`` pytree: halo tails, sparse dirty tails, 1-tick ``prev``
snapshots and hold seeds, the stream clock, and revision-ring entries —
plays the part weights play: :func:`state_from_numpy` turns the
reference's (numpy arrays) into tensors the port's ``restore`` takes, and
:func:`state_to_numpy` turns the port's into numpy arrays the reference's
``restore`` takes, so a stream started in one package continues in the
other.  Both packages keep time on the last axis of every scalar-per-tick
leaf (all the apps' payloads), so the arrays carry over as they are.
Nothing here imports the reference package: callers pass its arrays.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from .core.stream import SnapshotGrid
from .device import resolve

__all__ = ["to_grid", "to_numpy", "state_from_numpy", "state_to_numpy"]


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


def _is_array(x) -> bool:
    return isinstance(x, np.ndarray) or (
        hasattr(x, "__array__") and hasattr(x, "dtype")
        and not torch.is_tensor(x) and not isinstance(x, np.generic))


def state_from_numpy(tree, device=None):
    """A state pytree with every array (numpy, or anything ``np.array``
    copies, such as a jax array) copied into a tensor on ``device`` (CUDA
    unless ``"cpu"`` is asked for); Python scalars (``__t``, ``started``,
    ring-entry chunk numbers) and the tree's structure are kept."""
    dev = resolve(device)
    return tree_map(lambda x: (torch.from_numpy(np.array(x, copy=True))
                               .to(dev) if _is_array(x) else x), tree)


def state_to_numpy(tree):
    """A state pytree with every tensor copied out as a numpy array; other
    leaves are kept."""
    return tree_map(lambda x: (x.detach().cpu().numpy().copy()
                               if torch.is_tensor(x) else x), tree)
