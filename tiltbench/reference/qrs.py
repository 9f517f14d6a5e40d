"""Plain reference of Pan-Tompkins QRS detection, per ECG lead.

The filters are Pan & Tompkins', "A Real-Time QRS Detection Algorithm",
IEEE Trans. Biomed. Eng. 32(3), 1985, at the 200 samples a second they
were designed for, on a lead's samples ``x``:

* low-pass ``H(z) = (1 - z^-6)^2 / (1 - z^-1)^2``: two sums of 6 ticks;
* high-pass ``H(z) = (-1 + 32 z^-16 - 32 z^-17 + z^-32) / (1 - z^-1)``,
  which is ``32 x(n - 16) - sum_{k=0}^{31} x(n - k)``;
* the derivative ``(2 x(n) + x(n-1) - x(n-3) - 2 x(n-4)) / 8`` (the paper's
  difference equation; its ``1/T`` scale is left out, which changes no
  flag, since a flag compares two values of one scale);
* squaring;
* the moving-window integration, the mean of the last 30 ticks (150 ms).

The threshold is the TiLT paper's (arXiv:2301.12030, Appendix A): half the
maximum of the integrated signal over the last 400 ticks (2 s).  A tick is
flagged where the integrated signal lies above it, and its answer is the
excess; every other tick has no answer.  Pan and Tompkins' adaptive
thresholds, search-back and refractory period are left out (they are
recursive).

A sample that is missing is no term of a sum, a mean or a maximum; a
window with none has no value, and a difference or a product of values
has one only where every term does.  Ticks before the stream hold none.

Written from those equations alone, in plain PyTorch: each window over the
previous chunk's last :func:`tail_ticks` ticks and this chunk, by prefix
sums and, for the maximum, by van Herk's blocks of prefix and suffix
maxima, a block of leads at a time.  ``evaluate`` runs in any dtype
(float64 is the reference, bfloat16 the control); ``numbers`` holds a
chunk's answers against the float64 reference.  ``params``, the
configuration's reference parameters, is empty: the query has none.
"""
from __future__ import annotations

import torch

__all__ = ["evaluate", "numbers", "tail_ticks"]

ROWS = 16          # leads per block, so that float64 temporaries stay small
MWI, THR = 30, 400  # the integration's and the threshold's windows, ticks


def tail_ticks(params: dict) -> int:
    """Ticks of a lead before a chunk that the chunk's answers read: the
    two 6-tick sums (5 + 5), the 32-tick sum (31), the derivative (4), the
    integration (29) and the threshold's maximum (399): 473."""
    return 5 + 5 + 31 + 4 + (MWI - 1) + (THR - 1)


def _shift(v, m, d: int):
    """``x(n - d)``: ``d`` ticks later, the first ``d`` missing."""
    if d == 0:
        return v, m
    v = torch.cat([torch.zeros_like(v[..., :d]), v[..., :-d]], -1)
    m = torch.cat([torch.zeros_like(m[..., :d]), m[..., :-d]], -1)
    return v, m


def _wsum(v, m, w: int):
    """Sum and count of the present samples of ``[n - w + 1, n]``."""
    def last_w(c):
        lo = torch.cat([torch.zeros_like(c[..., :w]), c[..., :-w]], -1)
        return c - lo
    s = last_w(torch.cumsum(torch.where(m, v, torch.zeros_like(v)), -1))
    n = last_w(torch.cumsum(m.long(), -1))
    return s, n


def _wmax(v, m, w: int):
    """Maximum of the present samples of ``[n - w + 1, n]`` (van Herk:
    blocks of ``w``, the maximum from each block's start and to its end,
    then the window is one block's suffix and the next one's prefix)."""
    K, T = v.shape
    x = torch.where(m, v, torch.full_like(v, float("-inf")))
    pad = (-(T + w - 1)) % w
    x = torch.cat([torch.full_like(x[:, :w - 1], float("-inf")), x,
                   torch.full_like(x[:, :pad], float("-inf"))], -1)
    b = x.reshape(K, -1, w)
    pre = torch.cummax(b, -1).values.reshape(K, -1)
    suf = torch.cummax(b.flip(-1), -1).values.flip(-1).reshape(K, -1)
    # the window of tick n is x[n .. n + w - 1] of the padded row
    return torch.maximum(suf[:, :T], pre[:, w - 1:w - 1 + T])


def _detect(x, m, dtype):
    """(excess, threshold, has) at every tick of the rows ``x``, computed
    in ``dtype``."""
    x = x.to(dtype)
    lp, n = _wsum(x, m, 6)
    lp, n = _wsum(lp, n > 0, 6)
    m = n > 0
    d16, m16 = _shift(lp, m, 16)
    s32, n32 = _wsum(lp, m, 32)
    hp, mh = 32 * d16 - s32, m16 & (n32 > 0)
    h1, m1 = _shift(hp, mh, 1)
    h3, m3 = _shift(hp, mh, 3)
    h4, m4 = _shift(hp, mh, 4)
    de = (2 * hp + h1 - h3 - 2 * h4) / 8
    md = mh & m1 & m3 & m4
    s, n = _wsum(de * de, md, MWI)
    mwi = s / n.clamp(min=1).to(dtype)
    has = n > 0                 # and so the threshold's window has a value
    thr = 0.5 * _wmax(mwi, has, THR)
    return mwi - thr, thr, has


def _joined(prev: dict, cur: dict, tail: int, k0: int, k1: int):
    """A block of leads: the previous chunk's last ``tail`` ticks, then
    this chunk."""
    if prev["valid"].shape[-1] < tail:
        raise ValueError(f"the previous chunk ({prev['valid'].shape[-1]} "
                         f"ticks) must cover the tail ({tail} ticks)")
    P = prev["valid"].shape[-1]
    x = torch.cat([prev["value"][k0:k1, P - tail:], cur["value"][k0:k1]], -1)
    m = torch.cat([prev["valid"][k0:k1, P - tail:], cur["valid"][k0:k1]], -1)
    return x, m


def _blocks(prev: dict, cur: dict, params: dict, dtype):
    """(k0, k1, excess, threshold, has) of each block of leads, at the
    ticks of ``cur``."""
    tail = tail_ticks(params)
    K = cur["in"]["valid"].shape[0]
    for k0 in range(0, K, ROWS):
        k1 = min(K, k0 + ROWS)
        x, m = _joined(prev["in"], cur["in"], tail, k0, k1)
        e, thr, has = _detect(x, m, dtype)
        yield k0, k1, e[:, tail:], thr[:, tail:], has[:, tail:]


def evaluate(prev: dict, cur: dict, params: dict, dtype=torch.float64):
    """The query's answers for chunk ``cur`` given the chunk before it:
    ``(value, valid)``, each ``(leads, ticks)``, computed in ``dtype``."""
    vals, valids = [], []
    for _k0, _k1, e, _thr, has in _blocks(prev, cur, params, dtype):
        vals.append(e)
        valids.append(has & (e > 0))
    return torch.cat(vals), torch.cat(valids)


def numbers(value, valid, prev: dict, cur: dict, params: dict) -> dict:
    """``{"qrs_err": e, "flags": n}`` for one chunk's answers ``(value,
    valid)``.  ``qrs_err`` is the largest displacement of the threshold,
    relative to the float64 reference's, that the answers show: at a tick
    both flag, ``|excess - excess_ref| / thr_ref``; at a tick only one
    flags, ``|excess_ref| / thr_ref`` (the threshold must have moved that
    far to flip it).  An answer where the reference has none (no sample
    in a window) is infinite, and so is a NaN answer.  ``flags`` counts
    the reference's."""
    worst = 0.0
    flags = 0
    for k0, k1, e, thr, has in _blocks(prev, cur, params, torch.float64):
        flag = has & (e > 0)
        got_v, got = value[k0:k1].double(), valid[k0:k1]
        scale = thr.abs().clamp(min=torch.finfo(torch.float64).tiny)
        d_both = torch.where(got & flag, (got_v - e).abs() / scale, 0.0)
        d_flip = torch.where(has & (got != flag), e.abs() / scale, 0.0)
        if bool((got & (~has | got_v.isnan())).any()):
            worst = float("inf")
        worst = max(worst, float(d_both.max()), float(d_flip.max()))
        flags += int(flag.sum())
    return {"qrs_err": worst, "flags": flags}
