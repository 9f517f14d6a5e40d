"""Masked window reductions over the kernels (port of
``repro.kernels.ops``).

``ops`` is the only kernel entry point the rest of the package uses.  It
keeps the reference's wrapper logic (``src/repro/kernels/ops.py:42-117``):
invalid ticks become 0 or ±inf, validity rides as an extra row (``-valid``
for ``min``), ``algo`` picks the block or the subtract-on-evict sum, and
windows below ``_SMALL_W`` shift-combine (``sliding_assoc``) or take the
prefix-scan path (``sliding_sum``).  Which implementation runs follows the
tensors' device: the kernels on CUDA, their plain versions on the CPU.

Values are ``(C, *B, T)`` channel stacks with validity ``(*B, T)``: the
leading key axes ``B`` of a keyed stream fold into the kernels' row axis
(rows are independent), which replaces the reference's ``vmap``.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from . import window_reduce as _wr

__all__ = ["sliding_sum", "sliding_assoc"]

_SMALL_W = 8


def _rows(stacked: torch.Tensor) -> torch.Tensor:
    return stacked.reshape(-1, stacked.shape[-1]).contiguous()


def sliding_sum(x: torch.Tensor, valid: torch.Tensor, window: int,
                algo: str = "block"):
    """Masked sliding-window sums of ``x: (C, *B, T)`` and the valid count
    ``(*B, T)``, both f32.

    ``algo='block'`` (default) is the Van Herk structure with ``+``: error
    bounded by the window's content.  ``algo='soe'`` is the paper's
    subtract-on-evict ``P[t] - P[t-W]`` over a global prefix scan, whose f32
    error grows with stream position.
    """
    C, T = x.shape[0], x.shape[-1]
    xm = torch.where(valid.unsqueeze(0), x, 0.0).float()
    stacked = torch.cat([xm, valid.unsqueeze(0).float()], dim=0)
    if algo == "block" and window >= _SMALL_W:
        s = _wr.sliding_assoc(_rows(stacked), window, "add")
    else:
        p = _wr.prefix_scan(_rows(stacked))
        s = p - _ref.shift_right(p, window, 0.0)
    s = s.reshape(stacked.shape)
    return s[:C], s[C]


def sliding_assoc(x: torch.Tensor, valid: torch.Tensor, window: int,
                  op: str):
    """Masked sliding-window max/min of ``x: (C, *B, T)``.

    Returns ``(values (C, *B, T), any_valid (*B, T) bool)``; validity rides
    as an extra channel (sliding any == sliding max of the mask).
    """
    kop = "max" if op in ("max", "absmax") else "min"
    combine, identity, _ = _wr.COMBINES[kop]
    C = x.shape[0]
    xm = torch.where(valid.unsqueeze(0), x, identity).float()
    if window < _SMALL_W:
        return _ref.sliding_assoc_ref(xm, valid, window, combine, identity)
    vch = valid.unsqueeze(0).float()
    # any-valid via max even when the payload combine is min
    stacked = torch.cat([xm, -vch if op == "min" else vch], dim=0)
    out = _wr.sliding_assoc(_rows(stacked), window, kop)
    out = out.reshape(stacked.shape)
    anyv = (out[C] < -0.5) if op == "min" else (out[C] > 0.5)
    return out[:C], anyv

