"""Partitioned and keyed TiLT query execution (port of the one-shot half of
``repro.core.parallel``).

Boundary resolution gives a per-input halo contract; this module turns it
into the two one-shot execution strategies:

* :func:`partition_run` — host loop over time partitions (the paper's
  worker-thread model, one partition at a time), each fed its planned
  window of every input: ``left_halo`` lookback ticks, ``core`` fresh
  ticks, ``right_halo`` lookahead ticks, φ beyond the stream's ends.
* :func:`batch_run` — keyed streams: every input carries a leading key axis
  ``(K, T)`` and the query runs once over all keys, the key axis riding
  along every tensor (and folded into the kernels' row axis).

Both run on the device the input tensors live on.  The chunked executors
are :class:`repro_torch.engine.Runner`; :class:`StreamRunner` and
:class:`SparseStreamRunner` survive here as its deprecated wrappers.  The
time-sharded executor waits for the multi-device slice (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from . import compile as qcompile
from .stream import SnapshotGrid

__all__ = ["partition_run", "batch_run", "slice_grid", "StreamRunner",
           "SparseStreamRunner"]


def _slice_pad(value, valid, lo: int, hi: int):
    """Slice ticks [lo, hi) of a grid (time on the last axis), padding
    out-of-range ticks with φ (zero value, ``valid=False``)."""
    T = valid.shape[-1]
    lo_c, hi_c = max(lo, 0), min(hi, T)
    pad_l, pad_r = lo_c - lo, hi - hi_c

    def one(leaf):
        s = leaf[..., lo_c:max(hi_c, lo_c)]
        if pad_l or pad_r:
            s = F.pad(s, (pad_l, pad_r))
        return s

    return tree_map(one, value), one(valid)


def slice_grid(grid: SnapshotGrid, t0: int, t_end: int) -> SnapshotGrid:
    """Grid restricted to (t0, t_end]; out-of-range ticks are φ."""
    p = grid.prec
    if (t0 - grid.t0) % p or (t_end - t0) % p:
        raise ValueError(
            f"slice ({t0}, {t_end}] misaligned with grid "
            f"(t0={grid.t0}, prec={p})")
    lo = (t0 - grid.t0) // p
    hi = (t_end - grid.t0) // p
    v, m = _slice_pad(grid.value, grid.valid, lo, hi)
    return SnapshotGrid(value=v, valid=m, t0=t0, prec=p)


def _grid_window(g: SnapshotGrid, t0: int, length: int):
    # same alignment guard as slice_grid: a misaligned partition origin
    # must raise, not floor-divide into a time-shifted window
    if (t0 - g.t0) % g.prec:
        raise ValueError(
            f"partition window start {t0} misaligned with input grid "
            f"(t0={g.t0}, prec={g.prec})")
    lo = (t0 - g.t0) // g.prec
    return _slice_pad(g.value, g.valid, lo, lo + length)


def partition_run(exe: qcompile.CompiledQuery,
                  inputs: Dict[str, SnapshotGrid],
                  out_t0: int, n_parts: int,
                  interpreted: bool = False) -> SnapshotGrid:
    """Run ``n_parts`` partitions of ``exe.out_len`` output ticks each,
    starting at ``out_t0``, stitching the outputs."""
    span = exe.out_len * exe.out_prec
    outs_v, outs_m = [], []
    for k in range(n_parts):
        p0 = out_t0 + k * span
        part_in = {name: _grid_window(inputs[name], p0 + spec.t0,
                                      spec.length)
                   for name, spec in exe.input_specs.items()}
        res = (exe.run_interpreted(part_in) if interpreted
               else exe.fn(part_in))
        outs_v.append(res[0])
        outs_m.append(res[1])
    value = tree_map(lambda *xs: torch.cat(xs, dim=-1), *outs_v)
    valid = torch.cat(outs_m, dim=-1)
    return SnapshotGrid(value=value, valid=valid, t0=out_t0,
                        prec=exe.out_prec)


def batch_run(exe: qcompile.CompiledQuery,
              inputs: Dict[str, SnapshotGrid]) -> SnapshotGrid:
    """Keyed/partitioned-stream execution (paper §6.2's *other* parallelism
    axis): input grids carry a leading key axis ``(K, T)`` — one
    sub-stream per stock symbol / user / campaign — and the compiled query
    runs once over all keys.  Each input is φ-padded by its planned halo."""
    flat_in = {}
    for name, spec in exe.input_specs.items():
        g = inputs[name]
        hl, hr = spec.left_halo, spec.right_halo
        flat_in[name] = (tree_map(lambda x: F.pad(x, (hl, hr)), g.value),
                         F.pad(g.valid, (hl, hr)))
    val, msk = exe.fn(flat_in)
    return SnapshotGrid(value=val, valid=msk, t0=0, prec=exe.out_prec)


@dataclasses.dataclass
class StreamRunner:
    """Continuous chunked execution with carried halo state (deprecated
    alias for ``repro_torch.engine.Runner(exe, ExecPolicy())``).

    The only cross-chunk state is, per input, the trailing ``left_halo``
    ticks of the previous chunk — exactly the boundary-resolution contract.
    Queries must be lookback-only.
    """

    exe: qcompile.CompiledQuery
    _runner: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        from ..engine.policy import ExecPolicy
        from ..engine.runner import Runner
        warnings.warn(
            "StreamRunner is deprecated; use repro_torch.engine.Runner with "
            "ExecPolicy()", DeprecationWarning, stacklevel=3)
        self._runner = Runner(self.exe, ExecPolicy())

    def step(self, chunks: Dict[str, SnapshotGrid]) -> SnapshotGrid:
        """Feed exactly one partition's worth of new core ticks per input."""
        return self._runner.step(chunks)

    def state(self) -> Dict[str, tuple]:
        """Checkpointable runner state (host arrays)."""
        return self._runner.state()

    def restore(self, state: Dict) -> None:
        self._runner.restore(state, strict=False)


@dataclasses.dataclass
class SparseStreamRunner:
    """Change-compressed continuous execution (deprecated alias for
    ``repro_torch.engine.Runner(exe, ExecPolicy(body="sparse"),
    segs_per_chunk)``).

    Each step feeds ``segs_per_chunk`` partitions' worth of fresh ticks and
    only the partitions whose dilated input lineage saw a change are
    computed; the rest hold the previous output (see
    :mod:`repro_torch.core.sparse`).  The carried state is the halo
    contract plus its change metadata: dirty tails, 1-tick snapshots and
    the hold seed.  ``exe`` must be compiled with ``sparse=True``.
    """

    exe: qcompile.CompiledQuery
    segs_per_chunk: int = 8
    _runner: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        from ..engine.policy import ExecPolicy
        from ..engine.runner import Runner
        warnings.warn(
            "SparseStreamRunner is deprecated; use repro_torch.engine.Runner "
            "with ExecPolicy(body='sparse')", DeprecationWarning,
            stacklevel=3)
        if self.exe.change_plan is None:
            raise ValueError("SparseStreamRunner needs a query compiled "
                             "with sparse=True")
        self._runner = Runner(self.exe, ExecPolicy(body="sparse"),
                              segs_per_chunk=self.segs_per_chunk)

    def step(self, chunks: Dict[str, SnapshotGrid]) -> SnapshotGrid:
        """Feed ``segs_per_chunk`` partitions' worth of fresh core ticks
        per input; compute only the dirty ones."""
        return self._runner.step(chunks)

    # -- checkpointing (historical flat format, translated to the runner's
    #    state pytree) --------------------------------------------------------
    def state(self) -> Dict:
        """Checkpointable runner state (host arrays): halo tails + change
        metadata (dirty tails, 1-tick snapshots, hold seed)."""
        c = self._runner.state()
        sp = c.pop("__sparse")
        t = c.pop("__t")
        return {"tails": c, "dirty": sp["dirty"], "prev": sp["prev"],
                "seed": sp["seed"].get("__out"), "__t": t}

    def restore(self, state: Dict) -> None:
        seed = state["seed"]
        canonical = dict(state["tails"])
        canonical["__t"] = state["__t"]
        canonical["__sparse"] = {
            "dirty": state["dirty"], "prev": state["prev"],
            "seed": {} if seed is None else {"__out": seed},
            "started": True}
        self._runner.restore(canonical, strict=False)
