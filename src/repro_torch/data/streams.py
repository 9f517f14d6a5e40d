"""Change-compressed input streams and the fraud-style query of the
reference's sparse benchmark (``benchmarks/fig_sparse.py``), kept here in
the port's own copy: the numpy generators are the reference's, the query
is built with the port's frontend.

Real streams hold their value for long spans and change in bursts
(sessions, market moves).  :func:`burst_stream` is one such stream, with a
chosen share of changed ticks; :func:`keyed_activity` is the keyed form,
where a share of the keys is active (changes every tick) and the rest
hold.  :func:`burst_grids` / :func:`keyed_activity_grids` put them on a
device (CUDA unless ``"cpu"`` is asked for).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.frontend import TStream
from ..core.stream import SnapshotGrid
from ..device import resolve

__all__ = ["BURST", "burst_stream", "keyed_activity", "fraud_query",
           "burst_grids", "keyed_activity_grids"]

BURST = 128  # change-burst length (a fraud session / market move)


def burst_stream(n: int, rate: float, seed: int,
                 burst: int = BURST) -> np.ndarray:
    """Piecewise-constant integer-valued stream whose value changes on
    ~``rate`` of ticks, arriving in bursts of ``burst`` consecutive
    changes (``fig_sparse.burst_stream``)."""
    rng = np.random.default_rng(seed)
    change = np.zeros(n, bool)
    if rate >= 1.0:
        change[:] = True
    else:
        n_bursts = max(int(n * rate) // burst, 1)
        for s in rng.integers(0, max(n - burst, 1), n_bursts):
            change[s:s + burst] = True
    change[0] = True
    raw = np.floor(rng.random(n) * 100).astype(np.float32)
    idx = np.maximum.accumulate(np.where(change, np.arange(n), -1))
    return raw[idx]


def keyed_activity(n_keys: int, n_ticks: int, rate: float,
                   seed: int) -> np.ndarray:
    """``(K, T)`` integer-valued keyed streams: ``rate`` of the keys are
    active and take a fresh value every tick, the rest hold one value (the
    ``fig_sparse`` scale sweep's data)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 100, size=(n_keys, 1)).astype(np.float32)
    vals = np.broadcast_to(base, (n_keys, n_ticks)).copy()
    n_act = max(1, int(round(n_keys * rate)))
    act = rng.choice(n_keys, size=n_act, replace=False)
    vals[act] = rng.integers(0, 100, size=(n_act, n_ticks)).astype(
        np.float32)
    return vals


def fraud_query(window: int, keyed: bool = False) -> TStream:
    """Trailing mean + stddev → threshold → excess → where
    (``fig_sparse._fraud_query``)."""
    s = TStream.source("in", prec=1, keyed=keyed)
    mu = s.window(window).mean().shift(1)
    sd = s.window(window).stddev().shift(1)
    thr = mu.join(sd, lambda m, d: m + 3.0 * d, name="thr")
    return (s.join(thr, lambda x, t: x - t, name="excess")
            .where(lambda e: e > 0, name="flag"))


def _grid(vals: np.ndarray, device) -> dict:
    dev = resolve(device)
    v = torch.from_numpy(np.ascontiguousarray(vals, np.float32)).to(dev)
    return {"in": SnapshotGrid(value=v, valid=torch.ones(
        vals.shape, dtype=torch.bool, device=dev), t0=0, prec=1)}


def burst_grids(n: int, rate: float, seed: int, device=None) -> dict:
    """``{"in": grid}`` of one :func:`burst_stream`, every tick valid."""
    return _grid(burst_stream(n, rate, seed), device)


def keyed_activity_grids(n_keys: int, n_ticks: int, rate: float, seed: int,
                         device=None) -> dict:
    """``{"in": grid}`` of :func:`keyed_activity` streams, every tick
    valid."""
    return _grid(keyed_activity(n_keys, n_ticks, rate, seed), device)
