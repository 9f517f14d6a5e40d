"""The paper's benchmark applications (Table 2 + Appendix A); port of
``repro.data.apps``.

Each application factory returns an :class:`App` carrying:
* ``query``      — the TiLT query (frontend → IR), with its ``Map`` and
  ``Where`` functions written with torch,
* ``spe``        — the equivalent EventSPE pipeline (the event-centric
  baseline, numpy, :mod:`repro_torch.spe.eventspe`),
* ``make_input`` — the synthetic data generator (numpy, the reference's
  code: the same seed gives the same arrays in both packages),
* dataset/time-scale metadata.

:func:`make_grids` turns a generator's arrays into ``SnapshotGrid``s on a
device (CUDA unless ``"cpu"`` is asked for).  Beside the paper's nine
apps: ``qrs``, Pan-Tompkins QRS detection with the published
filters, one key an ECG lead (the benchmark's MIT-BIH deployment); the
dashboard fan-out of the multi-query sharing workload
(:func:`dashboard_queries`, :func:`dashboard_input`,
:func:`dashboard_keyed_input`) and the four primitive temporal operations
(:func:`temporal_op`, ``TEMPORAL_OPS``).

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
from ..spe import eventspe as es

__all__ = ["App", "APPS", "KEYED_APPS", "make_app", "make_keyed_app",
           "make_grids", "temporal_op", "TEMPORAL_OPS", "dashboard_queries",
           "dashboard_input", "dashboard_keyed_input"]


@dataclasses.dataclass
class App:
    name: str
    query: TStream               # TiLT IR
    spe: es.Pipeline             # event-centric baseline
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

    spe = es.Pipeline([
        (es.WindowAgg("mean", short), ("in",), "a_s"),
        (es.WindowAgg("mean", long), ("in",), "a_l"),
        (es.Join(lambda a, b: a - b), ("a_s", "a_l"), "diff"),
        (es.Where(lambda d: d > 0), ("diff",), "out"),
    ])

    def mk_keyed(n_keys, n_ticks, seed):
        rng = np.random.default_rng(seed)
        walks = 100.0 + np.cumsum(
            rng.normal(0, 0.05, (n_keys, n_ticks)), axis=1)
        return {"in": {"value": walks.astype(np.float64),
                       "valid": np.ones((n_keys, n_ticks), bool)}}

    return App("trend", q, spe,
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

    spe = es.Pipeline([
        (es.ShiftOp(1), ("in",), "prev"),
        (es.Join(lambda x, p: x - p), ("in", "prev"), "delta"),
        (es.Select(lambda d: np.maximum(d, 0.0)), ("delta",), "gain"),
        (es.Select(lambda d: np.maximum(-d, 0.0)), ("delta",), "loss"),
        (es.WindowAgg("mean", period), ("gain",), "ag"),
        (es.WindowAgg("mean", period), ("loss",), "al"),
        (es.Join(lambda g, l: 100.0 - 100.0 / (1.0 + g / np.maximum(l, 1e-9))),
         ("ag", "al"), "out"),
    ])

    return App("rsi", q, spe,
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

    spe = es.Pipeline([
        (es.WindowAgg("mean", win, stride=win), ("in",), "mu"),
        (es.WindowAgg("stddev", win, stride=win), ("in",), "sd"),
        (_SpeZnormJoin(win), ("in", "mu", "sd"), "out"),
    ])

    return App("znorm", q, spe,
               lambda n, seed: {"in": _dense_input(_signal(n, seed)[0])},
               description="z-score normalization, 10-tick tumbling window")


class _SpeZnormJoin(es.Operator):
    """3-way join assigning each event the stats of its own window.

    (The event-centric engine needs a *custom* operator here — the exact
    kind of inflexibility §3 attributes to fixed operator vocabularies.)
    """

    def __init__(self, win: int):
        self.win = win

    def __call__(self, xb, mub, sdb):
        # window containing tick t ends at ceil(t/win)*win
        wend = ((xb.ts + self.win - 1) // self.win) * self.win
        idx = np.searchsorted(mub.ts, wend)
        idx_ok = idx < len(mub.ts)
        idx_c = np.clip(idx, 0, max(len(mub.ts) - 1, 0))
        mu = np.asarray(mub.value)[idx_c]
        sd = np.asarray(sdb.value)[idx_c]
        ok = xb.valid & idx_ok & mub.valid[idx_c] & sdb.valid[idx_c]
        val = (np.asarray(xb.value) - mu) / np.maximum(sd, 1e-9)
        return es.Batch(xb.ts, val, ok)


# ---------------------------------------------------------------------------
# 4. Signal imputation: Avg, Shift, Join (fill gaps with window mean)
# ---------------------------------------------------------------------------

def impute_app(win: int = 10) -> App:
    s = TStream.source("in", prec=1)
    mu = s.window(win, stride=win).mean().shift(-(win - 1), prec=1)
    q = s.coalesce(mu, name="imputed")

    spe = es.Pipeline([
        (es.WindowAgg("mean", win, stride=win), ("in",), "mu"),
        (_SpeImputeJoin(win), ("in", "mu"), "out"),
    ])

    def mk(n, seed):
        x, valid = _signal(n, seed, missing=0.1)
        return {"in": _dense_input(x, valid)}

    return App("impute", q, spe, mk,
               description="fill missing samples with window mean (1000 Hz)")


class _SpeImputeJoin(es.Operator):
    def __init__(self, win: int):
        self.win = win

    def __call__(self, xb, mub):
        wend = ((xb.ts + self.win - 1) // self.win) * self.win
        idx = np.searchsorted(mub.ts, wend)
        idx_ok = idx < len(mub.ts)
        idx_c = np.clip(idx, 0, max(len(mub.ts) - 1, 0))
        mu = np.asarray(mub.value)[idx_c]
        mu_ok = idx_ok & mub.valid[idx_c]
        val = np.where(xb.valid, np.asarray(xb.value), mu)
        return es.Batch(xb.ts, val, xb.valid | mu_ok)


# ---------------------------------------------------------------------------
# 5. Resampling: Select, Join, Shift, Chop  (linear interpolation)
# ---------------------------------------------------------------------------

def resample_app(out_prec: int = 4, max_gap: int = 16) -> App:
    # e.g. 1000 Hz -> 250 Hz with linear interpolation
    s = TStream.source("in", prec=1)
    q = s.resample(out_prec, max_gap=max_gap)

    spe = es.Pipeline([
        (es.InterpOp(1, out_prec, max_gap), ("in",), "out"),
    ])

    def mk(n, seed):
        x, valid = _signal(n, seed, missing=0.05)
        return {"in": _dense_input(x, valid)}

    return App("resample", q, spe, mk,
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

    spe = es.Pipeline([
        (es.ShiftOp(1), ("in",), "prev"),
        (es.Join(lambda x, p: x - p), ("in", "prev"), "deriv"),
        (es.Select(lambda d: d * d), ("deriv",), "sq"),
        (es.WindowAgg("mean", mwi_w), ("sq",), "mwi"),
        (es.WindowAgg("max", thr_w), ("mwi",), "mx"),
        (es.Select(lambda m: 0.5 * m), ("mx",), "thr"),
        (es.Join(lambda s_, t: s_ - t), ("mwi", "thr"), "d"),
        (es.Where(lambda d: d > 0), ("d",), "out"),
    ])

    def mk(n, seed):
        rng = np.random.default_rng(seed)
        t = np.arange(n) / fs
        ecg = (0.1 * np.sin(2 * np.pi * 1.0 * t)
               + 1.2 * (np.sin(2 * np.pi * 1.2 * t) ** 63)  # QRS-ish spikes
               + 0.05 * rng.normal(0, 1, n))
        return {"in": _dense_input(ecg)}

    return App("pantomkins", q, spe, mk,
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

    spe = es.Pipeline([
        (es.WindowAgg("kurtosis", win, stride=win), ("in",), "k"),
        (es.WindowAgg("rms", win, stride=win), ("in",), "r"),
        (es.WindowAgg("absmax", win, stride=win), ("in",), "m"),
        (es.Join(lambda a, r: a / np.maximum(r, 1e-9)), ("m", "r"), "c"),
        (_SpeZip3(), ("k", "r", "c"), "out"),
    ])

    def mk(n, seed):
        rng = np.random.default_rng(seed)
        x = rng.normal(0, 1, n) + 0.5 * np.sin(np.arange(n) * 0.1)
        x[rng.random(n) < 0.001] *= 8.0  # bearing impacts
        return {"in": _dense_input(x)}

    return App("vibration", q, spe, mk,
               description="kurtosis/RMS/crest-factor machine monitoring")


class _SpeZip3(es.Operator):
    def __call__(self, kb, rb, cb):
        return es.Batch(kb.ts, {"kurtosis": np.asarray(kb.value),
                                "rms": np.asarray(rb.value),
                                "crest": np.asarray(cb.value)},
                        kb.valid & rb.valid & cb.valid)


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

    spe = es.Pipeline([
        (es.WindowAgg("mean", win), ("in",), "mu"),
        (es.WindowAgg("stddev", win), ("in",), "sd"),
        (es.ShiftOp(1), ("mu",), "mu1"),
        (es.ShiftOp(1), ("sd",), "sd1"),
        (es.Join(lambda m, d: m + 3.0 * d), ("mu1", "sd1"), "thr"),
        (es.Join(lambda x, t: x - t), ("in", "thr"), "ex"),
        (es.Where(lambda e: e > 0), ("ex",), "out"),
    ])

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

    return App("fraud", q, spe, mk,
               description="credit-card anomaly flagging (Kaggle-style)",
               make_keyed_input=mk_keyed)


# ---------------------------------------------------------------------------
# Yahoo Streaming Benchmark: Select, Where, tumbling-window count
# ---------------------------------------------------------------------------

def ysb_app(win: int = 10, keyed: bool = False) -> App:
    s = TStream.source("in", prec=1, keyed=keyed)
    views = s.where(lambda v: v["etype"] == 1.0, name="views")
    q = views.window(win, stride=win).count(field="etype", name="cnt")

    spe = es.Pipeline([
        (es.Where(lambda v: v["etype"] == 1.0), ("in",), "views"),
        (_SpeDictCount(win), ("views",), "out"),
    ])

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

    return App("ysb", q, spe, mk,
               description="Yahoo streaming benchmark (filter+project+count)",
               make_keyed_input=mk_keyed)


class _SpeDictCount(es.Operator):
    def __init__(self, win):
        self.agg = es.WindowAgg("count", win, stride=win)

    def reset(self):
        self.agg.reset()

    def __call__(self, b):
        return self.agg(es.Batch(b.ts, np.asarray(b.value["etype"]), b.valid))


# ---------------------------------------------------------------------------
# Pan-Tompkins QRS detection with the published filters, per ECG lead
# ---------------------------------------------------------------------------

# the integration (150 ms) and the threshold's maximum (2 s) in ticks at
# 200 samples/s, the one rate the filters' taps are designed for
_QRS_MWI, _QRS_THR = 30, 400


def _highpass(delayed, wsum):
    return 32.0 * delayed - wsum


def _derivative(x0, x1, x3, x4):
    return (2.0 * x0 + x1 - x3 - 2.0 * x4) / 8.0


def qrs_app(keyed: bool = False) -> App:
    """Pan & Tompkins, "A Real-Time QRS Detection Algorithm" (IEEE Trans.
    Biomed. Eng. 32(3), 1985) at the 200 samples/s the filters were
    designed for: the low-pass ``(1 - z^-6)^2 / (1 - z^-1)^2`` (two 6-tick
    sums), the high-pass ``32 x(n-16) - sum_0^31 x(n-k)``, the 5-point
    derivative ``(2x(n) + x(n-1) - x(n-3) - 2x(n-4)) / 8``, squaring and
    the 150 ms moving-window integration.  The threshold is the TiLT
    paper's (Appendix A, as :func:`pantomkins_app`): half the trailing
    2 s maximum of the integrated signal; a tick is flagged where the
    signal is above it, and its answer is the excess.  The paper's
    adaptive SPKI/NPKI thresholds, search-back and refractory period are
    recursive and left out.  Its input is one lead's samples, as signed
    ADC codes."""
    s = TStream.source("in", prec=1, keyed=keyed)
    lp = s.window(6).sum().window(6).sum()
    hp = lp.shift(16).join(lp.window(32).sum(), _highpass, name="highpass")
    deriv = TStream.zip([hp.shift(d) for d in (0, 1, 3, 4)], _derivative,
                        name="deriv")
    sq = deriv.select(lambda d: d * d, name="square")
    mwi = sq.window(_QRS_MWI).mean()
    thr = mwi.window(_QRS_THR).max().select(lambda m: 0.5 * m, name="thr")
    q = mwi.join(thr, lambda sig, th: sig - th, name="qrs") \
           .where(lambda d: d > 0, name="qrs_hit")

    spe = es.Pipeline([
        (es.WindowAgg("sum", 6), ("in",), "lp1"),
        (es.WindowAgg("sum", 6), ("lp1",), "lp"),
        (es.ShiftOp(16), ("lp",), "lp16"),
        (es.WindowAgg("sum", 32), ("lp",), "lp32"),
        (es.Join(_highpass), ("lp16", "lp32"), "hp"),
        (es.ShiftOp(1), ("hp",), "hp1"),
        (es.ShiftOp(3), ("hp",), "hp3"),
        (es.ShiftOp(4), ("hp",), "hp4"),
        (_SpeZip(_derivative), ("hp", "hp1", "hp3", "hp4"), "deriv"),
        (es.Select(lambda d: d * d), ("deriv",), "sq"),
        (es.WindowAgg("mean", _QRS_MWI), ("sq",), "mwi"),
        (es.WindowAgg("max", _QRS_THR), ("mwi",), "mx"),
        (es.Select(lambda m: 0.5 * m), ("mx",), "thr"),
        (es.Join(lambda s_, t: s_ - t), ("mwi", "thr"), "d"),
        (es.Where(lambda d: d > 0), ("d",), "out"),
    ])

    def codes(shape, seed):
        # 11-bit ADC samples less the ADC zero, as MIT-BIH stores them
        rng = np.random.default_rng(seed)
        return rng.integers(-1024, 1024, shape).astype(np.float64)

    def mk(n, seed):
        return {"in": _dense_input(codes(n, seed))}

    def mk_keyed(n_keys, n_ticks, seed):
        return {"in": {"value": codes((n_keys, n_ticks), seed),
                       "valid": np.ones((n_keys, n_ticks), bool)}}

    return App("qrs", q, spe, mk,
               description="Pan-Tompkins QRS detection, one key an ECG lead",
               make_keyed_input=mk_keyed)


class _SpeZip(es.Operator):
    """Join of aligned streams of one timeline: ``fn`` of every value,
    valid where all are."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *bs):
        valid = bs[0].valid.copy()
        for b in bs[1:]:
            valid &= b.valid
        return es.Batch(bs[0].ts, self.fn(*(np.asarray(b.value) for b in bs)),
                        valid)


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
    "qrs": qrs_app,
}


def make_app(name: str, **kw) -> App:
    return APPS[name](**kw)


# apps with a keyed (partitioned-stream) variant
KEYED_APPS = ("trend", "fraud", "ysb", "qrs")


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


# ---------------------------------------------------------------------------
# dashboard fan-out: N query variants over shared windowed aggregates
# (the multi-query sharing workload — repro_torch.multiquery)
# ---------------------------------------------------------------------------

def _dash_trend_up(fast, slow, thr):
    return (fast.join(slow, lambda a, b: a - b, name="dash_diff")
            .where(lambda d, t=thr: d > t, name=f"up_{thr}"))


def _dash_trend_down(fast, slow, thr):
    return (fast.join(slow, lambda a, b: a - b, name="dash_diff")
            .where(lambda d, t=thr: d < -t, name=f"down_{thr}"))


def _dash_breakout(s, slow, vol, k):
    """Fraud-style band breakout: price above μ_long + k·σ_long."""
    return (TStream.zip([s, slow, vol],
                        lambda x, m, v, k=k: x - (m + k * v),
                        name=f"excess_{k}")
            .where(lambda e: e > 0, name="breakout"))


def _dash_momentum(fast, slow, vol, scale):
    """Projection head: volatility-normalized momentum (no threshold)."""
    return TStream.zip([fast, slow, vol],
                       lambda a, b, v, s=scale: s * (a - b)
                       / torch.clamp_min(v, 1e-6),
                       name=f"momentum_{scale}")


def dashboard_queries(n: int = 16, short: int = 20, long: int = 50,
                      keyed: bool = False) -> dict:
    """``n`` concurrent dashboard variants over one source: every query
    reads the same short/long sliding means and long sliding stddev and
    differs only in its final threshold / projection head — the
    serving-layer fan-out scenario where multi-query sharing collapses N
    passes over the stream into one.

    Returns ``{query_name: TStream}``.  Note the aggregates are deliberately
    rebuilt *per query* — structural fingerprinting (ir.fingerprint), not
    object sharing, is what the session relies on to deduplicate them.
    """
    out = {}
    for i in range(n):
        # fresh sub-expressions per query: sharing must be discovered
        s = TStream.source("in", prec=1, keyed=keyed)
        fast = s.window(short).mean()
        slow = s.window(long).mean()
        vol = s.window(long).stddev()
        thr = 0.05 * (i // 4)
        kind = i % 4
        if kind == 0:
            q = _dash_trend_up(fast, slow, thr)
        elif kind == 1:
            q = _dash_trend_down(fast, slow, thr)
        elif kind == 2:
            q = _dash_breakout(s, slow, vol, 1.0 + thr)
        else:
            q = _dash_momentum(fast, slow, vol, 1.0 + thr)
        out[f"q{i:02d}"] = q
    return out


def dashboard_input(n_ticks: int, seed: int) -> dict:
    """Random-walk price stream for the dashboard fan-out (unkeyed)."""
    return {"in": _dense_input(_randwalk(n_ticks, seed))}


def dashboard_keyed_input(n_keys: int, n_ticks: int, seed: int) -> dict:
    """Per-symbol random walks, (K, T) — the keyed dashboard scenario."""
    rng = np.random.default_rng(seed)
    walks = 100.0 + np.cumsum(
        rng.normal(0, 0.05, (n_keys, n_ticks)), axis=1)
    return {"in": {"value": walks.astype(np.float64),
                   "valid": np.ones((n_keys, n_ticks), bool)}}


# ---------------------------------------------------------------------------
# the four primitive temporal operations (Fig. 1 / Fig. 7a)
# ---------------------------------------------------------------------------

def temporal_op(name: str) -> App:
    s = TStream.source("in", prec=1)
    if name == "select":
        q = s.select(lambda v: v + 1.0)
        spe = es.Pipeline([(es.Select(lambda v: v + 1.0), ("in",), "out")])
    elif name == "where":
        q = s.where(lambda v: v % 2 == 0)
        spe = es.Pipeline([(es.Where(lambda v: v % 2 == 0), ("in",), "out")])
    elif name == "wsum":
        q = s.window(10, stride=5).sum()
        spe = es.Pipeline([(es.WindowAgg("sum", 10, 5), ("in",), "out")])
    elif name == "join":
        t = TStream.source("in2", prec=1)
        q = s.join(t, lambda a, b: a + b)
        spe = es.Pipeline([(es.Join(lambda a, b: a + b), ("in", "in2"), "out")])
    else:  # pragma: no cover
        raise KeyError(name)

    def mk(n, seed):
        rng = np.random.default_rng(seed)
        d = {"in": _dense_input(np.floor(rng.random(n) * 100))}
        if name == "join":
            e = _dense_input(np.floor(rng.random(n) * 100))
            e["valid"] = rng.random(n) > 0.3  # irregular second stream
            d["in2"] = e
        return d

    return App(name, q, spe, mk, description=f"primitive op {name}")


TEMPORAL_OPS = ("select", "where", "wsum", "join")
