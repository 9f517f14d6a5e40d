"""User-facing temporal query builder; port of ``repro.core.frontend``.

The surface API mirrors the familiar event-centric operator vocabulary of
Fig. 1 (Select / Where / Join / Window-aggregates / Shift / Chop), but every
call constructs time-centric IR (ir.py) — this is the translation stage of
the paper's Fig. 3, done eagerly.

Example (the paper's running stock-trend query, §2 / Fig. 2a)::

    stock = TStream.source("stock", prec=1)
    avg10 = stock.window(10).mean()
    avg20 = stock.window(20).mean()
    diff  = avg10.join(avg20, lambda a, b: a - b)
    query = diff.where(lambda d: d > 0)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils._pytree import tree_map

from . import ir

__all__ = ["TStream", "WindowSpec"]


@dataclasses.dataclass(frozen=True)
class TStream:
    """A temporal object under construction (wraps an IR node)."""

    node: ir.Node

    # -- sources ------------------------------------------------------------
    @staticmethod
    def source(name: str, prec: int = 1, fields: Sequence[str] = (),
               keyed: bool = False) -> "TStream":
        """Declare a source stream.  ``keyed=True`` marks a partitioned
        stream of independent per-key sub-streams (fraud per-user, YSB
        per-campaign); execute it with
        :func:`repro_torch.core.parallel.batch_run`."""
        return TStream(ir.Input.make(name, prec=prec, fields=tuple(fields),
                                     keyed=keyed))

    @staticmethod
    def const(value: Any, prec: int = 1) -> "TStream":
        return TStream(ir.Const.make(value, prec=prec))

    # -- per-event ops (Fig. 1a/1b) ------------------------------------------
    def select(self, fn: Callable[[Any], Any], name: Optional[str] = None
               ) -> "TStream":
        return TStream(ir.Map.make(fn, [self.node], name=name))

    map = select

    def field(self, key: str) -> "TStream":
        return self.select(lambda v, _k=key: v[_k], name=f"field_{key}")

    def where(self, pred: Callable[[Any], Any],
              name: Optional[str] = None) -> "TStream":
        return TStream(ir.Where.make(pred, self.node, name=name))

    # -- temporal join (Fig. 1c) ----------------------------------------------
    def join(self, other: "TStream", fn: Callable[[Any, Any], Any] = None,
             name: Optional[str] = None) -> "TStream":
        fn = fn or (lambda a, b: (a, b))
        return TStream(ir.Map.make(fn, [self.node, other.node], name=name))

    @staticmethod
    def zip(streams: Sequence["TStream"], fn: Callable[..., Any],
            prec: Optional[int] = None,
            name: Optional[str] = None) -> "TStream":
        return TStream(ir.Map.make(fn, [s.node for s in streams], prec=prec,
                                   name=name))

    def coalesce(self, other: "TStream",
                 name: Optional[str] = None) -> "TStream":
        """``self[t] != φ ? self[t] : other[t]`` (φ-aware left-join /
        imputation pattern, paper Table 2)."""
        def fn(a, b):
            (av, aok), (bv, bok) = a, b
            v = tree_map(lambda x, y: torch.where(aok, x, y), av, bv)
            return v, aok | bok

        return TStream(ir.Map.make(fn, [self.node, other.node],
                                   phi_aware=True, prec=self.node.prec,
                                   name=name or "coalesce"))

    # -- time manipulation -----------------------------------------------------
    def shift(self, delta: int, name: Optional[str] = None,
              prec: Optional[int] = None) -> "TStream":
        return TStream(ir.Shift.make(self.node, delta, name=name, prec=prec))

    def interpolate(self, mode: str = "linear", max_gap: int = 0,
                    prec: Optional[int] = None,
                    name: Optional[str] = None) -> "TStream":
        """Gap fill / frequency change (imputation & resampling apps)."""
        return TStream(ir.Interp.make(self.node, mode=mode, max_gap=max_gap,
                                      prec=prec, name=name))

    def resample(self, new_prec: int, max_gap: int) -> "TStream":
        """Linear-interpolation resampling (paper's Chop+Select pipeline)."""
        return self.interpolate(mode="linear", max_gap=max_gap, prec=new_prec)

    # -- windows (Fig. 1d) -------------------------------------------------------
    def window(self, size: int, stride: Optional[int] = None) -> "WindowSpec":
        return WindowSpec(self, size, stride)

    @property
    def prec(self) -> int:
        return self.node.prec


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    stream: TStream
    size: int
    stride: Optional[int] = None

    def reduce(self, op: Any, field: Optional[str] = None,
               name: Optional[str] = None) -> TStream:
        return TStream(ir.Reduce.make(op, self.stream.node, self.size,
                                      stride=self.stride, field=field,
                                      name=name))

    def sum(self, **kw) -> TStream:
        return self.reduce("sum", **kw)

    def count(self, **kw) -> TStream:
        return self.reduce("count", **kw)

    def mean(self, **kw) -> TStream:
        return self.reduce("mean", **kw)

    def avg(self, **kw) -> TStream:
        return self.reduce("mean", **kw)

    def stddev(self, **kw) -> TStream:
        return self.reduce("stddev", **kw)

    def max(self, **kw) -> TStream:
        return self.reduce("max", **kw)

    def min(self, **kw) -> TStream:
        return self.reduce("min", **kw)

    def rms(self, **kw) -> TStream:
        return self.reduce("rms", **kw)

    def kurtosis(self, **kw) -> TStream:
        return self.reduce("kurtosis", **kw)

    def absmax(self, **kw) -> TStream:
        return self.reduce("absmax", **kw)
