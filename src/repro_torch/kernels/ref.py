"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

These are the semantics of record.  On a CPU tensor the kernel wrappers
(:mod:`.window_reduce`, :mod:`.sparse_compact`, :mod:`.fused_query`) run
them in place of the CUDA kernels; on the card ``chip_smoke.py`` holds
each kernel against them.

Window convention: ``out[t]`` aggregates input ticks ``[t-W+1, t]`` clipped
to the start of the array.  Every function works along the last axis, so
leading key/channel axes ride along.
"""
from __future__ import annotations

import torch

__all__ = ["prefix_sum_ref", "sliding_sum_ref", "sliding_assoc_ref",
           "sliding_assoc_block_ref", "seg_dirty_fused_ref",
           "fused_trend_block_ref"]


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


def seg_dirty_fused_ref(mats, geoms, n_segs: int) -> torch.Tensor:
    """Plain version of :func:`.sparse_compact.seg_dirty`: fused per-source
    tick diff → dilated-lineage range reduction → per-segment dirty flags.

    ``mats`` are ``(..., C, T)`` channel matrices (leading key axes ride
    along; rows of one matrix share a dtype, matrices may differ) and
    ``geoms`` the matching ``(a0, step, width)`` triples
    (:func:`repro_torch.core.plan.seg_range_affine`): segment ``k`` is dirty
    iff any tick in ``[a0 + k·step, a0 + k·step + width)`` changed.  Tick
    ``t`` of a matrix *changed* iff any row differs from tick ``t-1`` (a
    value ``!=``: NaN is always a change, -0.0 equals 0.0); tick 0 and
    out-of-range ticks never changed.  Returns ``(..., n_segs)`` bool.
    """
    lead = mats[0].shape[:-2]
    dev = mats[0].device
    seg = torch.zeros(lead + (n_segs,), dtype=torch.bool, device=dev)
    k = torch.arange(n_segs, device=dev)
    for x, (a0, step, width) in zip(mats, geoms):
        if width <= 0:
            continue
        T = x.shape[-1]
        d = (x[..., 1:] != x[..., :-1]).any(dim=-2)      # d[t-1] = tick t
        c = torch.cat([torch.zeros(lead + (1,), dtype=torch.int64,
                                   device=dev),
                       torch.cumsum(d.to(torch.int64), dim=-1)], dim=-1)
        lo = torch.clamp(a0 + k * step - 1, 0, T - 1)     # d index of tick
        hi = torch.clamp(a0 + k * step + width - 1, 0, T - 1)
        seg = seg | ((c[..., hi] - c[..., torch.minimum(lo, hi)]) > 0)
    return seg


def fused_trend_block_ref(x: torch.Tensor, w1: int, w2: int):
    """Plain version of :func:`.fused_query.fused_trend`, in the kernel's
    stripe formulation (the Pallas body's): the timeline, led by one stripe
    of zeros, is cut into rows of width ``w2``; a trailing ``w``-sum at
    ``t = k·w2 + j`` is ``P_k[j] - P_k[j-w]`` (``j >= w``) or ``P_k[j] +
    S_{k-1}[w2 - (w-1-j)]``, from per-row prefix sums ``P`` and suffix sums
    ``S``, so no f32 partial sum spans more than ``w2`` ticks.  ``x: (T,)``;
    returns ``(diff (T,) f32, uptrend (T,) bool)``.
    """
    T, W = x.shape[-1], int(w2)
    Tp = -(-T // W) * W
    z = torch.zeros(W, dtype=torch.float32, device=x.device)
    xp = torch.cat([z, x.float(), z[:Tp - T]]).reshape(-1, W)
    prefix = torch.cumsum(xp, dim=-1)[1:]
    suffix = torch.flip(torch.cumsum(torch.flip(xp, (-1,)), dim=-1),
                        (-1,))[:-1]
    j = torch.arange(W, device=x.device)

    def wsum(w):
        before = prefix[:, torch.clamp(j - w, min=0)]
        intra = prefix - torch.where(j >= w, before, 0.0)
        need = w - 1 - j
        tail = suffix[:, torch.clamp(W - need, 0, W - 1)]
        return intra + torch.where(need > 0, tail, 0.0)

    pos = torch.arange(Tp, device=x.device).reshape(-1, W)
    c1 = torch.clamp(pos + 1, max=w1).float()
    c2 = torch.clamp(pos + 1, max=W).float()
    diff = (wsum(w1) / c1 - wsum(W) / c2).reshape(Tp)[:T]
    return diff, diff > 0
