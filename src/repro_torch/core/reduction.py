"""Reduction functions (paper §4.1 ``⊕`` and §6.1.2 templates); port of
``repro.core.reduction``.

Every reduction is described by the paper's four-lambda template
(Init / Acc / Result / optional Deacc).  On the device we exploit the template
algebraically instead of folding event-by-event:

* **Invertible** ops (Deacc exists: sum, count, product-of-nonzeros, mean,
  stddev, moment sums) lower to *prefix-scan + subtract-on-evict*:
  ``fold(x[t-W:t]) = P[t] - P[t-W]`` where ``P`` is an inclusive prefix sum.
  This is the Subtract-on-Evict algorithm [Hirzel et al., DEBS'17] the paper
  cites, vectorized over all ticks at once.

* **Non-invertible but associative** ops (max, min) lower to the
  Van Herk / Gil-Werman two-pass sliding reduction (O(1) per element).

The generic (Init, Acc, Result) template remains available for custom
reductions; compile.py folds those with an associative two-level combine.

A reduction may consume multiple *derived channels* of the input (e.g.
stddev needs Σx and Σx²).  ``pre`` maps the raw payload to the channel
tuple, ``post`` maps folded channel sums (+ valid count) to the result.
All channels of the built-ins are invertible, so a single fused prefix-scan
kernel serves them all.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import math

import torch

__all__ = ["Reduction", "REDUCTIONS", "get_reduction"]


@dataclasses.dataclass(frozen=True)
class Reduction:
    name: str
    kind: str  # 'scan' (invertible, prefix-scan) | 'assoc' (van-herk) | 'generic'
    # -- scan kind ---------------------------------------------------------
    # pre: payload -> tuple of channel arrays to prefix-sum (invalid ticks
    #      contribute the additive identity 0).
    pre: Optional[Callable[[Any], tuple]] = None
    # post: (channel window-sums tuple, count of valid ticks) -> value
    post: Optional[Callable[[tuple, Any], Any]] = None
    # -- assoc kind --------------------------------------------------------
    combine: Optional[Callable[[Any, Any], Any]] = None
    identity: Any = None
    # -- generic kind (paper template) --------------------------------------
    init: Optional[Callable[[], Any]] = None
    acc: Optional[Callable[[Any, Any], Any]] = None
    result: Optional[Callable[[Any], Any]] = None
    deacc: Optional[Callable[[Any, Any], Any]] = None
    # empty-window validity: if False, a window with zero valid ticks is φ
    empty_valid: bool = False


def _ipow(x, y: int):
    """``x**y`` for an integer ``y >= 1`` by the same square-and-multiply
    order as ``lax.integer_pow``, so both packages round alike."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _sq(x):
    return x * x


def _at_least_1(n):
    return torch.clamp(n, min=1.0)


REDUCTIONS: dict[str, Reduction] = {
    "sum": Reduction(
        name="sum", kind="scan",
        pre=lambda x: (x,),
        post=lambda sums, n: sums[0]),
    "count": Reduction(
        name="count", kind="scan",
        pre=lambda x: (torch.ones_like(x),),
        post=lambda sums, n: n),
    "mean": Reduction(
        name="mean", kind="scan",
        pre=lambda x: (x,),
        post=lambda sums, n: sums[0] / _at_least_1(n)),
    # population stddev over the window: sqrt(E[x^2] - E[x]^2)
    "stddev": Reduction(
        name="stddev", kind="scan",
        pre=lambda x: (x, x * x),
        post=lambda sums, n: torch.sqrt(torch.clamp(
            sums[1] / _at_least_1(n)
            - _sq(sums[0] / _at_least_1(n)), min=0.0))),
    # Vibration-analysis composite moments (paper Table 2): rms, kurtosis,
    # crest factor share the moment channels; max goes via 'assoc'.
    "rms": Reduction(
        name="rms", kind="scan",
        pre=lambda x: (x * x,),
        post=lambda sums, n: torch.sqrt(sums[0] / _at_least_1(n))),
    "kurtosis": Reduction(
        name="kurtosis", kind="scan",
        pre=lambda x: (x, _ipow(x, 2), _ipow(x, 3), _ipow(x, 4)),
        post=lambda s, n: _kurtosis_post(s, n)),
    "max": Reduction(
        name="max", kind="assoc",
        combine=torch.maximum, identity=-math.inf),
    "min": Reduction(
        name="min", kind="assoc",
        combine=torch.minimum, identity=math.inf),
    "absmax": Reduction(  # crest factor numerator; pre maps payload first
        name="absmax", kind="assoc", pre=lambda x: (torch.abs(x),),
        combine=torch.maximum, identity=-math.inf),
}


def _kurtosis_post(s, n):
    """Excess-free sample kurtosis from raw moment sums (m4 / m2^2)."""
    n = _at_least_1(n)
    m1 = s[0] / n
    m2 = s[1] / n - _ipow(m1, 2)
    m3 = s[2] / n - 3 * m1 * (s[1] / n) + 2 * _ipow(m1, 3)
    m4 = (s[3] / n - 4 * m1 * (s[2] / n) + 6 * _ipow(m1, 2) * (s[1] / n)
          - 3 * _ipow(m1, 4))
    return m4 / torch.clamp(m2 * m2, min=1e-30)


def get_reduction(op: Any) -> Reduction:
    if isinstance(op, Reduction):
        return op
    try:
        return REDUCTIONS[op]
    except KeyError:
        raise KeyError(f"unknown reduction {op!r}; register it in "
                       f"reduction.REDUCTIONS or pass a Reduction") from None
