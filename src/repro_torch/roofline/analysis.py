"""Roofline terms from a traced dry-run step (port of
``repro.roofline.analysis``).

Three terms per (arch × shape × mesh) cell, in seconds a step on the
target, one NVIDIA H100 per rank (derived from the trace, not measured):

    compute    = FLOPs / peak FLOP/s                  [per device]
    memory     = bytes accessed / HBM bandwidth       [per device]
    collective = Σ collective bytes on the wire / link bandwidth

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
scrapes collectives from the optimized HLO.  The port has no HLO: the
dry-run runs one eager step over ``DTensor`` parameters and a ``fake``
process group, and :class:`StepTrace`, a ``TorchDispatchMode``, sees the
*local* program every rank runs: each aten op on the rank's shards and
each functional collective DTensor runs
(``_c10d_functional.all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``all_to_all_single``, and ``_dtensor.shard_dim_alltoall``,
its all-to-all between two shard dimensions on CUDA groups), with its
bytes and group size.
The collective records convert to bytes on the wire with the reference's
ring factors:

    all-gather      out × (g-1)/g        reduce-scatter  out × (g-1)
    all-reduce      2 × size × (g-1)/g   all-to-all      size × (g-1)/g
    collective-permute  size

The reference's while-loop trip multiplier has no counterpart: an eager
trace records every layer's and every microbatch's collectives as they
run.  A group of one rank moves nothing (the reference floors an
unreadable group at two).
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["HW", "collective_bytes", "roofline", "RooflineReport",
           "StepTrace"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the 700 W
    limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s from 80 GB of
    HBM3; ``link_bw`` is one 400 Gb/s NDR InfiniBand port per GPU, as a
    DGX H100 gives each GPU (50 GB/s): a (16, 16) mesh of 8-GPU nodes puts
    every mesh axis across nodes, and NVLink's 450 GB/s a direction holds
    only inside a node."""

    peak_flops: float = 989e12     # bf16 dense
    hbm_bw: float = 3.35e12        # B/s
    link_bw: float = 50e9          # B/s per GPU across nodes
    hbm_bytes: float = 80e9


# (namespace, functional collective) -> the reference's HLO kind
_KINDS = {("_c10d_functional", "all_gather_into_tensor"): "all-gather",
          ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
          ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
          ("_c10d_functional", "all_reduce"): "all-reduce",
          ("_c10d_functional", "all_reduce_"): "all-reduce",
          ("_c10d_functional", "all_to_all_single"): "all-to-all",
          ("_dtensor", "shard_dim_alltoall"): "all-to-all"}


def _wire(kind: str, size: float, g: int) -> float:
    """Bytes on the wire of one collective of ``size`` bytes (the HLO
    shape the reference reads: the gathered or scattered output, else the
    operand) over a group of ``g`` ranks."""
    frac = (g - 1) / g if g > 0 else 0.0
    if kind == "all-gather":
        return size * frac
    if kind == "all-reduce":
        return 2 * size * frac
    if kind == "reduce-scatter":
        return size * (g - 1)
    if kind == "all-to-all":
        return size * frac
    return size  # collective-permute


def collective_bytes(records: Iterable[dict]) -> Dict[str, float]:
    """Per-device bytes on the wire by collective kind (ring-algorithm
    model) from trace records ``{"kind", "bytes", "group", "count"}``,
    with their ``total``."""
    out: Dict[str, float] = {}
    for r in records:
        out[r["kind"]] = (out.get(r["kind"], 0.0)
                          + r["count"] * _wire(r["kind"], r["bytes"],
                                               r["group"]))
    out["total"] = sum(out.values())
    return out


@dataclasses.dataclass
class RooflineReport:
    flops: float                 # per-device flops of the local program
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device bytes on wire
    coll_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float           # 6·N·D useful flops (per device)
    hw: HW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs: remat and redundancy waste."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achievable if the step runs at
        the dominant-term time: useful_compute_time / bound_time."""
        useful_s = self.model_flops / self.hw.peak_flops
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline(cost: dict, collectives: Iterable[dict],
             model_flops_per_device: float,
             hw: Optional[HW] = None) -> RooflineReport:
    """The three terms of ``cost`` (``{"flops", "bytes accessed"}`` of the
    local program) and the recorded ``collectives`` on ``hw``."""
    hw = hw or HW()
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(collectives)
    return RooflineReport(
        flops=flops, hbm_bytes=hbm, coll_bytes=coll["total"],
        coll_breakdown={k: v for k, v in coll.items() if k != "total"},
        compute_s=flops / hw.peak_flops,
        memory_s=hbm / hw.hbm_bw,
        collective_s=coll["total"] / hw.link_bw,
        model_flops=model_flops_per_device, hw=hw)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """The group size of a functional collective: its ``group_size``
    argument where it has one, else its group's size."""
    schema = func._schema
    for a, v in zip(schema.arguments, args):
        if a.name == "group_size":
            return int(v)
    group = args[[a.name for a in schema.arguments].index("group_name")]
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(group)
    return group.size()


def _propagating() -> bool:
    """Whether the op runs inside DTensor's sharding propagation, which
    runs each new op once over global-shaped fake tensors to infer its
    output's metadata: no rank runs that."""
    f = sys._getframe(2)
    while f is not None:
        if "sharding_prop" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


class StepTrace(TorchDispatchMode):
    """The local program of one step, as each rank runs it: entered
    around an eager step over ``DTensor`` operands, it lets every
    ``DTensor`` op through to DTensor's dispatch (returning
    ``NotImplemented``) and records what that dispatch runs on the rank's
    shards:

    * ``flops``: FLOPs of each op PyTorch's ``FlopCounterMode`` counts
      (matmuls, convolutions, fused attention), from the local shapes;
    * ``bytes``: bytes accessed, each op's tensor operands read once and
      its outputs written once (views, collectives and waits excluded);
    * ``collectives``: ``{(kind, bytes, group): count}``;
    * ``peak_bytes``: the peak of the live bytes of storages created
      during the step (an op's new outputs, freed when the last tensor on
      them is dropped): a model of the eager caching allocator without its
      rounding or fragmentation, not of XLA's buffer assignment.
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[tuple, int] = {}
        self.live = 0
        self.peak_bytes = 0
        self._storages: set = set()

    def records(self) -> list:
        return [{"kind": k, "bytes": b, "group": g, "count": n}
                for (k, b, g), n in sorted(self.collectives.items())]

    def _free(self, key, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages.add(key)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _propagating():
            return out
        ns = func.namespace
        kind = _KINDS.get((ns, func._schema.name.split("::")[-1]))
        if kind is not None:
            ref = out if kind in ("all-gather", "reduce-scatter") else args[0]
            key = (kind, _nbytes(ref), _group_size(func, args))
            self.collectives[key] = self.collectives.get(key, 0) + 1
        packet = func._overloadpacket
        if packet in self._flop_fns:
            self.flops += int(self._flop_fns[packet](*args, **kwargs,
                                                     out_val=out))
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if (kind is None and ns not in ("_c10d_functional", "prim")
                and not func.is_view):
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs))
                              if isinstance(t, torch.Tensor))
            if not aliased:
                self.bytes += sum(_nbytes(t) for t in tree_leaves(out)
                                  if isinstance(t, torch.Tensor))
            elif func._schema.is_mutable:
                # an in-place op writes its output over an operand
                self.bytes += sum(_nbytes(t) for t in tree_leaves(out)
                                  if isinstance(t, torch.Tensor))
        if not aliased:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out
