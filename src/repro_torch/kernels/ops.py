"""Masked window reductions over the kernels (port of
``repro.kernels.ops``).

``ops`` is the only kernel entry point the rest of the package uses.  It
keeps the reference's wrapper logic (``src/repro/kernels/ops.py:42-117``):
invalid ticks become 0 or ±inf, validity rides as an extra row (``-valid``
for ``min``), ``algo`` picks the block or the subtract-on-evict sum, and
max/min windows below ``_SMALL_W`` shift-combine.  One departure: the
reference's block sums of windows below ``_SMALL_W`` take the prefix-scan
path, whose f32 error grows with a row's offset from zero; here every
block sum is the block structure.  Which implementation runs follows the
tensors' device: the kernels on CUDA, their plain versions on the CPU.

Values are ``C`` channels with validity ``(*B, T)``: a ``(C, *B, T)``
tensor or a sequence of ``C`` tensors ``(*B, T)``, read in place either
way.  :func:`.window_reduce.masked_rows` writes the masked channels and
the validity row as one ``(C + 1, *B, T)`` buffer; the leading key axes
``B`` of a keyed stream fold into the kernels' row axis (rows are
independent), which replaces the reference's ``vmap``.
"""
from __future__ import annotations

import torch

from . import ref as _ref
from . import window_reduce as _wr

__all__ = ["sliding_sum", "sliding_assoc"]

_SMALL_W = 8


def _channels(x) -> tuple:
    """The channels of ``x``: views of a ``(C, *B, T)`` tensor, or the
    sequence as given."""
    return x.unbind(0) if isinstance(x, torch.Tensor) else tuple(x)


def _rows(rows: torch.Tensor) -> torch.Tensor:
    return rows.reshape(-1, rows.shape[-1])


def sliding_sum(x, valid: torch.Tensor, window: int, algo: str = "block"):
    """Masked sliding-window sums of the channels ``x`` and the valid
    count ``(*B, T)``, both f32.

    ``algo='block'`` (default) is the Van Herk structure with ``+`` at every
    window: error bounded by the window's content.  ``algo='soe'`` is the
    paper's subtract-on-evict ``P[t] - P[t-W]`` over a global prefix scan,
    whose f32 error grows with stream position.
    """
    chans = _channels(x)
    C = len(chans)
    rows = _wr.masked_rows(chans, valid, "add")
    if algo == "block":
        s = _wr.sliding_assoc(_rows(rows), window, "add")
    else:
        p = _wr.prefix_scan(_rows(rows))
        s = p - _ref.shift_right(p, window, 0.0)
    s = s.reshape(rows.shape)
    return s[:C], s[C]


def sliding_assoc(x, valid: torch.Tensor, window: int, op: str):
    """Masked sliding-window max/min of the channels ``x``.

    Returns ``(values (C, *B, T), any_valid (*B, T) bool)``; validity rides
    as an extra channel (sliding any == sliding max of the mask).
    """
    kop = "max" if op in ("max", "absmax") else "min"
    combine, identity, _ = _wr.COMBINES[kop]
    chans = _channels(x)
    C = len(chans)
    if window < _SMALL_W:
        # the shift-combine reads no validity row: mask the channels only
        xs = chans[0].unsqueeze(0) if C == 1 else torch.stack(chans)
        xm = torch.where(valid.unsqueeze(0), xs, identity).float()
        return _ref.sliding_assoc_ref(xm, valid, window, combine, identity)
    rows = _wr.masked_rows(chans, valid, kop)
    out = _wr.sliding_assoc(_rows(rows), window, kop).reshape(rows.shape)
    anyv = (out[C] < -0.5) if kop == "min" else (out[C] > 0.5)
    return out[:C], anyv
