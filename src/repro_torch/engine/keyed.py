"""Keyed multi-stream execution: K sub-streams × time partitions (paper
§6.2); port of ``repro.engine.keyed``.

.. deprecated::
    :class:`KeyedEngine` is a thin wrapper over the runner —
    ``Runner(exe, ExecPolicy(keys="vmapped", ...), n_keys=K)``.

An optional mesh shards the key axis: each rank computes its own keys and
carries their state (keys never communicate), and the results are
all-gathered along the key axis, so every rank reads every key.

Ingestion convention: every input grid carries a leading key axis — value
leaves are ``(K, ..., T)``, validity is ``(K, T)`` (time last, as
everywhere in the port).  ``SnapshotGrid.t0`` / ``prec`` refer to the
shared time grid.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..core import compile as qcompile
from ..core.stream import SnapshotGrid
from ..device import resolve
from ..launch.mesh import axis_comm
from .policy import ExecPolicy, MeshPlacement
from .runner import Runner

__all__ = ["KeyedEngine", "keyed_grid", "wrap_keyed_step"]


def keyed_grid(value, valid, t0: int = 0, prec: int = 1,
               device=None) -> SnapshotGrid:
    """A keyed SnapshotGrid from ``(K, T)`` arrays (numpy, or anything
    ``np.array`` copies), dtypes kept, on ``device`` (CUDA unless ``"cpu"``
    is asked for)."""
    dev = resolve(device)

    def put(a):
        if torch.is_tensor(a):
            return a.to(dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return SnapshotGrid(value=tree_map(put, value), valid=put(valid),
                        t0=t0, prec=prec)


def wrap_keyed_step(step, mesh: Optional[object] = None,
                    axis: str = "data"):
    """Stage a ``(tails, chunks) -> (out, new_tails)`` step for keyed
    execution over pytrees of tensors with the key axis first.  The port
    runs eagerly, so with ``mesh=None`` the step is returned as it is.
    With a mesh, the returned step shards the key axis along ``axis``:
    every rank passes the global trees, runs ``step`` on its own
    ``K / n`` keys (keys never communicate, so the body needs no
    collective) and gets both results back all-gathered along the key
    axis.  Deprecated: the runner builds its own steps; kept for callers
    that build custom keyed steps."""
    if mesh is None:
        return step
    comm = axis_comm(mesh, axis)

    def mine(x):
        k = x.shape[0] // comm.n
        return x[comm.rank * k:(comm.rank + 1) * k]

    def sharded(tails, chunks):
        out, new_tails = step(tree_map(mine, tails), tree_map(mine, chunks))

        def gather(t):
            return tree_map(lambda x: comm.all_gather(x, 0), t)

        return gather(out), gather(new_tails)

    return sharded


@dataclasses.dataclass
class KeyedEngine:
    """Continuous keyed execution with carried per-key halo state
    (deprecated alias for ``Runner(exe, ExecPolicy(keys='vmapped'))``).

    ``exe`` must be compiled for the per-partition ``out_len``; queries
    must be lookback-only.  ``mesh`` (optional) shards the key axis along
    ``axis``; ``n_keys`` must then be divisible by the axis size.
    ``sparse=True`` (requires ``compile_query(..., sparse=True)``)
    computes only the keys whose inputs changed; idle keys hold their
    previous output tick.  It composes with ``mesh``: the compaction is
    resolved per shard, so the gather never crosses ranks.
    """

    exe: qcompile.CompiledQuery
    n_keys: int
    mesh: object = None
    axis: str = "data"
    sparse: bool = False
    _runner: Runner = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        warnings.warn(
            "KeyedEngine is deprecated; use repro_torch.engine.Runner with "
            "ExecPolicy(keys='vmapped', ...)", DeprecationWarning,
            stacklevel=3)
        policy = ExecPolicy(
            body="sparse" if self.sparse else "dense", keys="vmapped",
            placement=(MeshPlacement(self.mesh, self.axis)
                       if self.mesh is not None else "local"))
        self._runner = Runner(self.exe, policy, n_keys=self.n_keys)

    # -- public API ----------------------------------------------------------
    def step(self, chunks: Dict[str, SnapshotGrid]) -> SnapshotGrid:
        """Advance every key by one partition of fresh core ticks.

        Each chunk grid must be ``(n_keys, spec.core)``; returns the
        ``(n_keys, out_len)`` output partition."""
        return self._runner.step(chunks)

    def run(self, inputs: Dict[str, SnapshotGrid],
            n_parts: int) -> SnapshotGrid:
        """Feed ``n_parts`` partitions sliced from full keyed streams and
        stitch the outputs along time."""
        return self._runner.run(inputs, n_parts)

    def reset(self) -> None:
        """Drop carried state; the next step starts a fresh stream at t=0."""
        self._runner.reset()

    # -- checkpointing (delegated to the runner's state/validate path) -------
    def state(self) -> Dict:
        """Checkpointable engine state (host arrays)."""
        return self._runner.state()

    def restore(self, state: Dict) -> None:
        """Restore a :meth:`state` checkpoint, validating it against this
        engine's configuration first (see :meth:`Runner.restore`)."""
        self._runner.restore(state)
