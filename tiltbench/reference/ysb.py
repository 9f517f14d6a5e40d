"""Plain reference of the Yahoo Streaming Benchmark query, per campaign.

The query (github.com/yahoo/streaming-benchmarks): keep the events whose
type is a view, and count them per campaign in tumbling windows of ``win``
ticks.  A window with no view has no answer.  The stream arrives keyed by
campaign, so a chunk is ``(campaigns, ticks)`` and its answers are
``(campaigns, ticks // win)``: window ``j`` of a chunk counts the chunk's
ticks ``[j * win, (j + 1) * win)``.

Written from that description alone, in plain PyTorch.  ``evaluate`` runs
in any dtype (float64 is the reference, bfloat16 the control); ``numbers``
holds a chunk's answers against the float64 reference.
"""
from __future__ import annotations

import torch

__all__ = ["evaluate", "numbers", "tail_ticks"]


def evaluate(prev: dict, cur: dict, params: dict, dtype=torch.float64):
    """Window counts of chunk ``cur``: ``(value, valid)``, each
    ``(campaigns, windows)``, counted in ``dtype`` (``prev`` is not read:
    a tumbling window never reaches back past its chunk)."""
    win, view = int(params["win"]), float(params["view"])
    etype, m = cur["in"]["value"]["etype"], cur["in"]["valid"]
    K, T = m.shape
    if T % win:
        raise ValueError(f"a chunk of {T} ticks is not whole windows of "
                         f"{win}")
    views = (m & (etype == view)).to(dtype).reshape(K, T // win, win)
    zero = torch.zeros((K, T // win, 1), dtype=dtype, device=m.device)
    c = torch.cat([zero, torch.cumsum(views, -1)], -1)
    count = c[..., -1] - c[..., 0]
    return count, count > 0


def numbers(value, valid, prev: dict, cur: dict, params: dict) -> dict:
    """``{"count_err": e, "windows": n}``: the largest absolute difference
    between an answer and the reference's count (infinite where one side
    has an answer and the other none), over the ``n`` windows compared."""
    want, has = evaluate(prev, cur, params, torch.float64)
    if bool((valid != has).any()):
        return {"count_err": float("inf"), "windows": int(has.numel())}
    d = torch.where(has, (value.double() - want).abs(), 0.0)
    return {"count_err": float(d.max()), "windows": int(has.numel())}


def tail_ticks(params: dict) -> int:
    """Ticks of a key's stream before a chunk that the chunk's answers
    read: none, since a tumbling window ends inside its chunk."""
    return 0
