"""How closely two runs of an app must agree, and the check that holds them
to it.

Two runs of the same query at identical partitioning (the port against the
reference, or the card against the CPU) add the same f32 terms in another
order, so each bound is a few ulps of what the windows hold: values of
~100 for the price apps (trend, rsi), N(0,1) samples for the signal apps.
fraud's threshold mu + 3 sd takes sd from E[x^2] - E[x]^2 over 1000-tick
windows of lognormal amounts with 50x spikes, so its rounding is
eps * E[x^2] / sd, up to ~1e-2.  ``gate`` excuses a validity flip of a
``> 0`` predicate whose operand lies within that distance of 0 (the
predicate's operands carry the same rounding).  ysb counts integers:
exact.  qrs's excess is the integrated signal less half its 2 s maximum,
both near 1e9-1e10 on the generator's ADC codes: an f32 ulp there is up
to 1e3, so two runs may differ by a few of them in the excess and flip a
flag within as much of its threshold.  ``dashboard`` holds the dashboard
fan-out's trend heads (``data.apps.dashboard_queries``: a difference of
two means of prices near 100, thresholded), as trend.  Its breakout and
momentum heads read the stddev of a 50-tick window of those prices,
E[x^2] - E[x]^2 with E[x^2] near 1e4 and a variance near 2e-2: an f32 ulp
of E[x^2] is 1e-3, so two runs that add in another order may differ by
tens of percent in that stddev, and no bound of this kind holds them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

# app -> (atol, rtol, gate)
TOLERANCE = {
    "trend": (1e-4, 1e-6, 1e-3),
    "rsi": (1e-3, 1e-5, 0.0),
    "znorm": (1e-4, 1e-5, 0.0),
    "impute": (1e-5, 1e-5, 0.0),
    "resample": (1e-6, 1e-6, 0.0),
    "pantomkins": (1e-6, 1e-5, 1e-5),
    "vibration": (1e-4, 1e-5, 0.0),
    "fraud": (2e-2, 1e-5, 0.1),
    "ysb": (0.0, 0.0, 0.0),
    "qrs": (1e5, 1e-5, 1e5),
    "dashboard": (1e-4, 1e-6, 1e-3),
}


def compare(name: str, got_valid: np.ndarray, got: Dict[str, np.ndarray],
            want_valid: np.ndarray, want: Dict[str, np.ndarray]) -> dict:
    """Hold one output grid against another, both as numpy (validity mask
    and a dict of value leaves): equal shapes, finite values where both are
    valid, ``|got - want| <= atol + rtol * |want|`` there, and validity
    equal except where ``gate`` excuses a flip.  Raises AssertionError;
    returns the largest difference, the flip count and the valid share."""
    atol, rtol, gate = TOLERANCE[name]
    if got_valid.shape != want_valid.shape or got.keys() != want.keys():
        raise AssertionError(f"{name}: shapes {got_valid.shape} "
                             f"vs {want_valid.shape}")
    both = got_valid & want_valid
    worst = 0.0
    for k in got:
        a, b = got[k], want[k]
        if a.shape != b.shape:
            raise AssertionError(f"{name}.{k}: {a.shape} vs {b.shape}")
        if not np.isfinite(a[both]).all():
            raise AssertionError(f"{name}.{k}: non-finite valid values")
        d = np.abs(a[both].astype(np.float64) - b[both])
        lim = atol + rtol * np.abs(b[both].astype(np.float64))
        if d.size and not (d <= lim).all():
            i = int(np.argmax(d - lim))
            raise AssertionError(f"{name}.{k}: |got - want| {d[i]} > "
                                 f"{lim[i]}")
        worst = max(worst, float(d.max()) if d.size else 0.0)
    flips = got_valid != want_valid
    v = np.abs(want[next(iter(want))][flips])
    if not (v <= gate).all():
        raise AssertionError(f"{name}: validity differs where |value| is "
                             f"{v.max()} > {gate}")
    return {"max_abs_diff": worst, "flips": int(flips.sum()),
            "valid_frac": float(got_valid.mean()) if got_valid.size else 0.0}
