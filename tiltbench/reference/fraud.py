"""Plain reference of the fraud-detection query, per card holder.

The query (TiLT paper, arXiv:2301.12030, Table 2 and Appendix A): a
transaction is flagged when it exceeds mu + 3 sigma of the trailing window
of ``win`` ticks, shifted one tick so that it does not mask itself.  mu and
sigma are the mean and the population standard deviation of the valid
amounts in that window; an empty window has no threshold.  The answer at a
flagged tick is the excess ``amount - (mu + 3 sigma)``; every other tick
has no answer.

Written from that description alone, in plain PyTorch: prefix sums of the
amounts, their squares and the event count over the previous chunk and
this one, differenced over the window.  ``evaluate`` runs in any dtype
(float64 is the reference, bfloat16 the control); ``numbers`` holds a
chunk's answers against the float64 reference.
"""
from __future__ import annotations

import torch

__all__ = ["evaluate", "numbers", "tail_ticks"]

ROWS = 4096        # keys per block, so that float64 temporaries stay small


def _threshold(prev: dict, cur: dict, win: int, dtype, k0: int, k1: int):
    """(thr, has_thr) at every tick of ``cur`` for keys ``k0:k1``: the
    window ``[t - win, t - 1]`` reaches back into ``prev``."""
    P = prev["valid"].shape[-1]
    T = cur["valid"].shape[-1]
    if P < win + 1:
        raise ValueError(f"the previous chunk ({P} ticks) must cover the "
                         f"window and its shift ({win + 1} ticks)")
    m = torch.cat([prev["valid"][k0:k1], cur["valid"][k0:k1]], dim=-1)
    x = torch.cat([prev["value"][k0:k1], cur["value"][k0:k1]], dim=-1)
    x = torch.where(m, x.to(dtype), torch.zeros((), dtype=dtype,
                                                device=x.device))
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=dtype, device=x.device)
    c1 = torch.cat([zero, torch.cumsum(x, -1)], -1)
    c2 = torch.cat([zero, torch.cumsum(x * x, -1)], -1)
    cn = torch.cat([zero.long(), torch.cumsum(m.long(), -1)], -1)
    # c[j] is the sum over ticks [0, j); the window of tick t (index P+i
    # in the joined stream) is ticks [t - win, t - 1], i.e. c[t] - c[t-win]
    hi = torch.arange(P, P + T, device=x.device)
    lo = hi - win
    n = cn[..., hi] - cn[..., lo]
    nd = n.clamp(min=1).to(dtype)
    mu = (c1[..., hi] - c1[..., lo]) / nd
    var = (c2[..., hi] - c2[..., lo]) / nd - mu * mu
    sd = torch.sqrt(torch.clamp(var, min=0))
    return mu + 3 * sd, n > 0


def evaluate(prev: dict, cur: dict, params: dict, dtype=torch.float64):
    """The query's answers for chunk ``cur`` given the chunk before it:
    ``(value, valid)``, each ``(keys, ticks)``, computed in ``dtype``."""
    x_in, m_in = cur["in"]["value"], cur["in"]["valid"]
    K = m_in.shape[0]
    vals, valids = [], []
    for k0 in range(0, K, ROWS):
        k1 = min(K, k0 + ROWS)
        thr, has = _threshold(prev["in"], cur["in"], int(params["win"]),
                              dtype, k0, k1)
        e = x_in[k0:k1].to(dtype) - thr
        vals.append(e)
        valids.append(m_in[k0:k1] & has & (e > 0))
    return torch.cat(vals), torch.cat(valids)


def numbers(value, valid, prev: dict, cur: dict, params: dict) -> dict:
    """``{"thr_err": e, "flags": n}`` for one chunk's answers ``(value,
    valid)``.  ``thr_err`` is the largest displacement of the threshold,
    relative to the float64 reference's, that the answers show: at a tick
    both flag, ``|excess - excess_ref| / thr_ref``; at a tick only one
    flags, ``|excess_ref| / thr_ref`` (the threshold must have moved that
    far to flip it).  An answer where the reference has none (no event, or
    an empty window) is infinite.  ``flags`` counts the reference's."""
    x_in, m_in = cur["in"]["value"], cur["in"]["valid"]
    K = m_in.shape[0]
    worst = torch.zeros((), dtype=torch.float64, device=m_in.device)
    flags = 0
    for k0 in range(0, K, ROWS):
        k1 = min(K, k0 + ROWS)
        thr, has = _threshold(prev["in"], cur["in"], int(params["win"]),
                              torch.float64, k0, k1)
        has = has & m_in[k0:k1]
        e = x_in[k0:k1].double() - thr
        flag = has & (e > 0)
        got_v, got = value[k0:k1].double(), valid[k0:k1]
        scale = thr.abs().clamp(min=torch.finfo(torch.float64).tiny)
        both = (got & flag)
        d_both = torch.where(both, (got_v - e).abs() / scale, 0.0)
        flip = has & (got != flag)
        d_flip = torch.where(flip, e.abs() / scale, 0.0)
        stray = got & ~has
        if bool(stray.any()):
            worst = torch.full_like(worst, float("inf"))
        worst = torch.maximum(worst, torch.maximum(d_both.max(),
                                                   d_flip.max()))
        flags += int(flag.sum())
    return {"thr_err": float(worst), "flags": flags}


def tail_ticks(params: dict) -> int:
    """Ticks of a key's stream before a chunk that the chunk's answers
    read: the first tick's window, ``[t - win, t - 1]``."""
    return int(params["win"])
