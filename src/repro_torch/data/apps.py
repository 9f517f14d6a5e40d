"""The paper's benchmark applications (Table 2 + Appendix A); port of
``repro.data.apps``.

Each application factory returns an :class:`App` carrying:
* ``query``      — the TiLT query (frontend → IR), with its ``Map`` and
  ``Where`` functions written with torch,
* ``make_input`` — the synthetic data generator (numpy, the reference's
  code: the same seed gives the same arrays in both packages),
* dataset/time-scale metadata.

:func:`make_grids` turns a generator's arrays into ``SnapshotGrid``s on a
device (CUDA unless ``"cpu"`` is asked for).  The EventSPE baselines, the
dashboard fan-out and the primitive temporal ops belong to later slices.

Window sizes follow the paper's descriptions (Appendix A); time unit = one
input tick.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core.frontend import TStream
from ..core.stream import SnapshotGrid
from ..device import resolve

__all__ = ["App", "APPS", "KEYED_APPS", "make_app", "make_keyed_app",
           "make_grids"]


@dataclasses.dataclass
class App:
    name: str
    query: TStream               # TiLT IR
    # (n_events, seed) -> {name: numpy arrays}
    make_input: Callable[[int, int], dict]
    input_prec: int = 1
    description: str = ""
    # keyed variant: (n_keys, n_ticks, seed) -> {name: {"value": (K,T),
    # "valid": (K,T)}}; query sources then carry keyed=True.
    make_keyed_input: Optional[Callable[[int, int, int], dict]] = None


def _randwalk(n, seed, mu=100.0, sigma=0.05):
    rng = np.random.default_rng(seed)
    return (mu + np.cumsum(rng.normal(0, sigma, n))).astype(np.float64)


def _signal(n, seed, missing=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n)
    valid = rng.random(n) >= missing
    return x, valid


def _dense_input(x, valid=None):
    n = len(x)
    return {"ts": np.arange(1, n + 1, dtype=np.int64),
            "value": np.asarray(x, np.float64),
            "valid": np.ones(n, bool) if valid is None else valid}


# ---------------------------------------------------------------------------
# 1. Trend-based trading (Fig. 2a): Avg(2), Join, Where
# ---------------------------------------------------------------------------

def trend_app(short: int = 20, long: int = 50, keyed: bool = False) -> App:
    s = TStream.source("in", prec=1, keyed=keyed)
    q = (s.window(short).mean()
         .join(s.window(long).mean(), lambda a, b: a - b, name="diff")
         .where(lambda d: d > 0, name="uptrend"))

    def mk_keyed(n_keys, n_ticks, seed):
        rng = np.random.default_rng(seed)
        walks = 100.0 + np.cumsum(
            rng.normal(0, 0.05, (n_keys, n_ticks)), axis=1)
        return {"in": {"value": walks.astype(np.float64),
                       "valid": np.ones((n_keys, n_ticks), bool)}}

    return App("trend", q,
               lambda n, seed: {"in": _dense_input(_randwalk(n, seed))},
               description="moving-average trend, NYSE-style prices",
               make_keyed_input=mk_keyed)


# ---------------------------------------------------------------------------
# 2. Relative strength index: Shift, Join, Avg(2)
# ---------------------------------------------------------------------------

def rsi_app(period: int = 14) -> App:
    s = TStream.source("in", prec=1)
    delta = s.join(s.shift(1), lambda x, px: x - px, name="delta")
    gain = delta.select(lambda d: torch.clamp(d, min=0.0), name="gain")
    loss = delta.select(lambda d: torch.clamp(-d, min=0.0), name="loss")
    ag = gain.window(period).mean()
    al = loss.window(period).mean()
    q = ag.join(al, lambda g, l: 100.0 - 100.0 / (
        1.0 + g / torch.clamp(l, min=1e-9)), name="rsi")

    return App("rsi", q,
               lambda n, seed: {"in": _dense_input(_randwalk(n, seed))},
               description="relative strength index momentum")


# ---------------------------------------------------------------------------
# 3. Normalization: Avg, StdDev, Join (z-score per tumbling window)
# ---------------------------------------------------------------------------

def znorm_app(win: int = 10) -> App:
    s = TStream.source("in", prec=1)
    # shift(-(win-1)) + hold-alignment broadcasts each tumbling window's
    # stats onto the ticks of that same window (t+win-1 floors to the
    # window-end tick for every t in the window).
    mu = s.window(win, stride=win).mean().shift(-(win - 1), prec=1)
    sd = s.window(win, stride=win).stddev().shift(-(win - 1), prec=1)
    q = TStream.zip([s, mu, sd],
                    lambda x, m, d: (x - m) / torch.clamp(d, min=1e-9),
                    prec=1, name="znorm")

    return App("znorm", q,
               lambda n, seed: {"in": _dense_input(_signal(n, seed)[0])},
               description="z-score normalization, 10-tick tumbling window")


# ---------------------------------------------------------------------------
# 4. Signal imputation: Avg, Shift, Join (fill gaps with window mean)
# ---------------------------------------------------------------------------

def impute_app(win: int = 10) -> App:
    s = TStream.source("in", prec=1)
    mu = s.window(win, stride=win).mean().shift(-(win - 1), prec=1)
    q = s.coalesce(mu, name="imputed")

    def mk(n, seed):
        x, valid = _signal(n, seed, missing=0.1)
        return {"in": _dense_input(x, valid)}

    return App("impute", q, mk,
               description="fill missing samples with window mean (1000 Hz)")


# ---------------------------------------------------------------------------
# 5. Resampling: Select, Join, Shift, Chop  (linear interpolation)
# ---------------------------------------------------------------------------

def resample_app(out_prec: int = 4, max_gap: int = 16) -> App:
    # e.g. 1000 Hz -> 250 Hz with linear interpolation
    s = TStream.source("in", prec=1)
    q = s.resample(out_prec, max_gap=max_gap)

    def mk(n, seed):
        x, valid = _signal(n, seed, missing=0.05)
        return {"in": _dense_input(x, valid)}

    return App("resample", q, mk,
               description="linear-interpolation resampling 1000→250 Hz")


# ---------------------------------------------------------------------------
# 6. Pan-Tompkins QRS detection: Custom-Agg(3), Select, Avg
# ---------------------------------------------------------------------------

def pantomkins_app(fs: int = 200) -> App:
    """Streaming Pan-Tompkins (derivative → square → MWI → adaptive
    threshold via trailing-max custom agg; see Appendix A)."""
    mwi_w = int(0.150 * fs)   # 150 ms moving-window integration
    thr_w = 2 * fs            # 2 s trailing max for the adaptive threshold
    s = TStream.source("in", prec=1)
    deriv = s.join(s.shift(1), lambda x, px: x - px, name="deriv")
    sq = deriv.select(lambda d: d * d, name="square")
    mwi = sq.window(mwi_w).mean()
    thr = mwi.window(thr_w).max().select(lambda m: 0.5 * m, name="thr")
    q = mwi.join(thr, lambda sig, th: sig - th, name="qrs") \
           .where(lambda d: d > 0, name="qrs_hit")

    def mk(n, seed):
        rng = np.random.default_rng(seed)
        t = np.arange(n) / fs
        ecg = (0.1 * np.sin(2 * np.pi * 1.0 * t)
               + 1.2 * (np.sin(2 * np.pi * 1.2 * t) ** 63)  # QRS-ish spikes
               + 0.05 * rng.normal(0, 1, n))
        return {"in": _dense_input(ecg)}

    return App("pantomkins", q, mk,
               description="QRS detection on synthetic ECG (MIMIC-III style)")


# ---------------------------------------------------------------------------
# 7. Vibration analysis: Max, Avg(2), Join(2), Custom-Agg
# ---------------------------------------------------------------------------

def vibration_app(win: int = 100) -> App:
    """kurtosis + RMS + crest factor over a tumbling window (100 ticks =
    100 ms at the paper's bearing-sensor rates)."""
    s = TStream.source("in", prec=1)
    kurt = s.window(win, stride=win).kurtosis()
    rms = s.window(win, stride=win).rms()
    amax = s.window(win, stride=win).absmax()
    crest = amax.join(rms, lambda a, r: a / torch.clamp(r, min=1e-9),
                      name="crest")
    q = TStream.zip([kurt, rms, crest],
                    lambda k, r, c: {"kurtosis": k, "rms": r, "crest": c},
                    name="vib")

    def mk(n, seed):
        rng = np.random.default_rng(seed)
        x = rng.normal(0, 1, n) + 0.5 * np.sin(np.arange(n) * 0.1)
        x[rng.random(n) < 0.001] *= 8.0  # bearing impacts
        return {"in": _dense_input(x)}

    return App("vibration", q, mk,
               description="kurtosis/RMS/crest-factor machine monitoring")


# ---------------------------------------------------------------------------
# 8. Fraud detection: Avg, StdDev, Shift, Join
# ---------------------------------------------------------------------------

def fraud_app(win: int = 1000, keyed: bool = False) -> App:
    """Flag transactions above μ+3σ of the *trailing* window (shifted one
    tick so current transactions don't mask themselves)."""
    s = TStream.source("in", prec=1, keyed=keyed)
    mu = s.window(win).mean().shift(1)
    sd = s.window(win).stddev().shift(1)
    thr = mu.join(sd, lambda m, d: m + 3.0 * d, name="thr")
    q = s.join(thr, lambda x, t: x - t, name="excess") \
         .where(lambda e: e > 0, name="fraud")

    def mk(n, seed):
        rng = np.random.default_rng(seed)
        amt = rng.lognormal(3.0, 1.0, n)
        amt[rng.random(n) < 0.002] *= 50.0  # injected fraud
        return {"in": _dense_input(amt)}

    def mk_keyed(n_keys, n_ticks, seed):
        rng = np.random.default_rng(seed)
        amt = rng.lognormal(3.0, 1.0, (n_keys, n_ticks))
        amt[rng.random((n_keys, n_ticks)) < 0.002] *= 50.0  # per-user fraud
        # sparse per-user activity: not every user transacts every tick
        valid = rng.random((n_keys, n_ticks)) > 0.3
        return {"in": {"value": amt, "valid": valid}}

    return App("fraud", q, mk,
               description="credit-card anomaly flagging (Kaggle-style)",
               make_keyed_input=mk_keyed)


# ---------------------------------------------------------------------------
# Yahoo Streaming Benchmark: Select, Where, tumbling-window count
# ---------------------------------------------------------------------------

def ysb_app(win: int = 10, keyed: bool = False) -> App:
    s = TStream.source("in", prec=1, keyed=keyed)
    views = s.where(lambda v: v["etype"] == 1.0, name="views")
    q = views.window(win, stride=win).count(field="etype", name="cnt")

    def mk(n, seed):
        rng = np.random.default_rng(seed)
        etype = (rng.integers(0, 3, n) == 1).astype(np.float64)
        camp = rng.integers(0, 100, n).astype(np.float64)
        return {"in": {"ts": np.arange(1, n + 1, dtype=np.int64),
                       "value": {"etype": etype, "camp": camp},
                       "valid": np.ones(n, bool)}}

    def mk_keyed(n_keys, n_ticks, seed):
        # one sub-stream per ad campaign (the benchmark's natural key)
        rng = np.random.default_rng(seed)
        sh = (n_keys, n_ticks)
        etype = (rng.integers(0, 3, sh) == 1).astype(np.float64)
        camp = np.broadcast_to(
            np.arange(n_keys, dtype=np.float64)[:, None], sh).copy()
        return {"in": {"value": {"etype": etype, "camp": camp},
                       "valid": np.ones(sh, bool)}}

    return App("ysb", q, mk,
               description="Yahoo streaming benchmark (filter+project+count)",
               make_keyed_input=mk_keyed)


APPS = {
    "trend": trend_app,
    "rsi": rsi_app,
    "znorm": znorm_app,
    "impute": impute_app,
    "resample": resample_app,
    "pantomkins": pantomkins_app,
    "vibration": vibration_app,
    "fraud": fraud_app,
    "ysb": ysb_app,
}


def make_app(name: str, **kw) -> App:
    return APPS[name](**kw)


# apps with a keyed (partitioned-stream) variant
KEYED_APPS = ("trend", "fraud", "ysb")


def make_keyed_app(name: str, **kw) -> App:
    """App with sources marked keyed=True and a (K, T) input generator."""
    if name not in KEYED_APPS:
        raise KeyError(f"{name} has no keyed variant (have {KEYED_APPS})")
    return APPS[name](keyed=True, **kw)


def make_grids(data: dict, device=None, t0: int = 0,
               prec: int = 1) -> dict:
    """``{name: SnapshotGrid}`` from a generator's ``{name: {"value",
    "valid"}}`` arrays (``(T,)`` or keyed ``(K, T)``), values as f32, on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    dev = resolve(device)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    out = {}
    for name, d in data.items():
        val = d["value"]
        v = ({k: put(a) for k, a in val.items()} if isinstance(val, dict)
             else put(val))
        valid = torch.as_tensor(np.asarray(d["valid"], bool)).to(dev)
        out[name] = SnapshotGrid(value=v, valid=valid, t0=t0, prec=prec)
    return out
