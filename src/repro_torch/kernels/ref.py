"""Plain PyTorch versions of the window kernels (port of
``repro.kernels.ref``).

These are the semantics of record.  On a CPU tensor the kernel wrappers
(:mod:`.window_reduce`) run them in place of the CUDA kernels; on the card
``chip_smoke.py`` holds each kernel against them.

Window convention: ``out[t]`` aggregates input ticks ``[t-W+1, t]`` clipped
to the start of the array.  Every function works along the last axis, so
leading key/channel axes ride along.
"""
from __future__ import annotations

import torch

__all__ = ["prefix_sum_ref", "sliding_sum_ref", "sliding_assoc_ref",
           "sliding_assoc_block_ref"]


def prefix_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, accumulated in f32."""
    acc = x.float() if x.dtype != torch.float64 else x
    return torch.cumsum(acc, dim=-1).to(x.dtype)


def shift_right(a: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``a`` delayed by ``d`` ticks along the last axis, ``fill`` shifted
    in."""
    T = a.shape[-1]
    d = min(d, T)
    head = torch.full(a.shape[:-1] + (d,), fill, dtype=a.dtype,
                      device=a.device)
    return torch.cat([head, a[..., :T - d]], dim=-1)


def sliding_sum_ref(x: torch.Tensor, valid: torch.Tensor, window: int):
    """Masked sliding-window sum + valid count.

    ``x: (C, T)`` values, ``valid: (T,)`` bool (invalid ticks add 0).
    Returns ``(sums (C, T) f32, count (T,) f32)``.
    """
    xm = torch.where(valid.unsqueeze(0), x, 0.0).float()
    p = torch.cumsum(xm, dim=-1)
    sums = p - shift_right(p, window, 0.0)
    c = torch.cumsum(valid.float(), dim=-1)
    return sums, c - shift_right(c, window, 0.0)


def sliding_assoc_ref(x: torch.Tensor, valid: torch.Tensor, window: int,
                      combine, identity):
    """Masked sliding-window associative reduce by O(W) shift-combine.

    ``x: (C, *B, T)``, ``valid: (*B, T)``.  Returns ``(values, any_valid)``.
    """
    xm = torch.where(valid.unsqueeze(0), x, identity)
    out, anyv = xm, valid
    for d in range(1, window):
        out = combine(out, shift_right(xm, d, identity))
        anyv = anyv | shift_right(valid, d, False)
    return out, anyv


def _scan_for(combine):
    """Inclusive scan along the last axis for one of the built-in combines,
    with a log-step (Hillis-Steele) scan for any other."""
    if combine is torch.add:
        return lambda a: torch.cumsum(a, dim=-1)
    if combine is torch.maximum:
        return lambda a: torch.cummax(a, dim=-1).values
    if combine is torch.minimum:
        return lambda a: torch.cummin(a, dim=-1).values

    def generic(a):
        n, d = a.shape[-1], 1
        while d < n:
            a = torch.cat([a[..., :d], combine(a[..., :-d], a[..., d:])], -1)
            d *= 2
        return a
    return generic


def sliding_assoc_block_ref(x: torch.Tensor, window: int, combine, identity,
                            scan_fn=None) -> torch.Tensor:
    """Van Herk / Gil-Werman on a striped reshape, in plain torch.

    The same decomposition as the CUDA kernel: the timeline, left-padded by
    one stripe of ``identity``, is cut into rows of width W; output tick
    ``kW + j`` combines the suffix of row k-1 after j with the prefix of row
    k up to j.  ``scan_fn(a, reverse)`` overrides the inclusive scan along
    the last axis.  ``x: (..., T)``.
    """
    T = x.shape[-1]
    W = int(window)
    if W <= 1:
        return x
    lead = x.shape[:-1]
    Tp = -(-T // W) * W
    xp = torch.cat([
        torch.full(lead + (W,), identity, dtype=x.dtype, device=x.device),
        x,
        torch.full(lead + (Tp - T,), identity, dtype=x.dtype,
                   device=x.device)], dim=-1)
    rows = xp.reshape(lead + (Tp // W + 1, W))
    if scan_fn is None:
        fwd = _scan_for(combine)
        scan_fn = (lambda a, rev: torch.flip(fwd(torch.flip(a, (-1,))),
                                             (-1,)) if rev else fwd(a))
    prefix = scan_fn(rows, False)[..., 1:, :]
    suffix = scan_fn(rows, True)[..., :-1, :]
    suf = torch.cat([suffix[..., 1:],
                     torch.full(suffix.shape[:-1] + (1,), identity,
                                dtype=x.dtype, device=x.device)], dim=-1)
    out = combine(suf, prefix).reshape(lead + (Tp,))
    return out[..., :T]
