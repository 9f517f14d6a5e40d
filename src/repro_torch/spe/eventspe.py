"""Event-centric interpreted SPE baseline (the paper's comparison target);
a copy of ``repro.spe.eventspe``, which uses numpy only (the port imports
nothing of the reference package, so it keeps its own copy).

A faithful stand-in for Trill's design [Chandramouli et al., VLDB'15] at the
granularity this reproduction needs:

* **event-centric**: operators transform batches of discrete events
  ``(ts, payload, valid)``; the time semantics live in runtime event
  timestamps, not in the representation (paper §3's core criticism).
* **columnar micro-batches**: payload columns are numpy arrays, and each
  operator is vectorized *within* a batch (Trill's columnar batching) but
  materializes its full output before the next operator runs
  (operator-at-a-time, message-queue hand-off).
* **interpreted**: the query is a DAG of operator objects walked at runtime;
  no cross-operator fusion, no codegen.

Operators keep per-instance state across batches (window ring buffers, shift
carries) exactly like a streaming iterator-model engine.  Batch size is the
latency/throughput knob measured in the paper's Fig. 9.

Fidelity notes (recorded for the benchmark write-up): Trill is C# with
managed-runtime overhead; our baseline is numpy, which is *faster* than an
event-at-a-time managed loop — so measured TiLT/EventSPE ratios are a
conservative *lower bound* on the paper's Trill speedups.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = [
    "Batch", "Operator", "Source", "Select", "Where", "ShiftOp", "WindowAgg",
    "Join", "Coalesce", "InterpOp", "Pipeline",
]


@dataclasses.dataclass
class Batch:
    """A columnar micro-batch of events on a regular time grid.

    ``ts`` are the event *end* timestamps (grid convention: tick time), and
    ``valid`` marks null events (φ) — Trill likewise carries deleted rows in
    its batches via a bitvector.
    """

    ts: np.ndarray      # int64[n]
    value: object       # np.ndarray[n] or dict[str, np.ndarray[n]]
    valid: np.ndarray   # bool[n]

    def __len__(self):
        return len(self.ts)


class Operator:
    """Base: stateful stream operator consuming/producing batches."""

    def reset(self):
        pass

    def __call__(self, batch: Batch) -> Batch:  # pragma: no cover
        raise NotImplementedError


class Source(Operator):
    def __call__(self, batch: Batch) -> Batch:
        return batch


class Select(Operator):
    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, b: Batch) -> Batch:
        return Batch(b.ts, self.fn(b.value), b.valid.copy())


class Where(Operator):
    def __init__(self, pred: Callable):
        self.pred = pred

    def __call__(self, b: Batch) -> Batch:
        keep = np.asarray(self.pred(b.value)) & b.valid
        return Batch(b.ts, b.value, keep)


class ShiftOp(Operator):
    """Delay events by ``delta`` ticks (carries a cross-batch tail)."""

    def __init__(self, delta_ticks: int):
        assert delta_ticks >= 0
        self.d = delta_ticks
        self.reset()

    def reset(self):
        self._tail_v: Optional[object] = None
        self._tail_m: Optional[np.ndarray] = None

    def __call__(self, b: Batch) -> Batch:
        d = self.d
        if d == 0:
            return b
        n = len(b)
        if self._tail_v is None:
            self._tail_v = _zeros_like_cols(b.value, d)
            self._tail_m = np.zeros(d, bool)
        v = _concat_cols(self._tail_v, b.value)
        m = np.concatenate([self._tail_m, b.valid])
        out_v = _slice_cols(v, 0, n)
        out_m = m[:n]
        self._tail_v = _slice_cols(v, n, n + d)
        self._tail_m = m[n:n + d]
        return Batch(b.ts, out_v, out_m)


class WindowAgg(Operator):
    """Sliding/tumbling window aggregate over a regular stream.

    Maintains a ring of the trailing ``W-1`` ticks; per batch, aggregates are
    computed columnar over ``sliding_window_view`` (max/min/kurtosis) or
    cumulative sums (sum/mean/stddev/rms) — the typical incremental-agg
    implementations of event-centric engines, vectorized per batch.
    Emits one event per ``stride`` ticks (event ts = window end).
    """

    def __init__(self, op: str, window: int, stride: int = 1):
        self.op, self.W, self.stride = op, window, stride
        self.reset()

    def reset(self):
        self._tail_v: Optional[np.ndarray] = None
        self._tail_m: Optional[np.ndarray] = None
        self._tick = 0  # absolute tick index of next input element

    def __call__(self, b: Batch) -> Batch:
        W = self.W
        x = np.asarray(b.value, dtype=np.float64)
        m = b.valid
        if self._tail_v is None:
            self._tail_v = np.zeros(W - 1)
            self._tail_m = np.zeros(W - 1, bool)
        xa = np.concatenate([self._tail_v, np.where(m, x, 0.0)])
        ma = np.concatenate([self._tail_m, m])
        n = len(b)
        # output positions: absolute ticks t in [tick, tick+n) with
        # (t+1) % stride == 0
        t0 = self._tick
        pos = np.arange(n)[(t0 + np.arange(n) + 1) % self.stride == 0]
        out_ts = b.ts[pos]
        win = np.lib.stride_tricks.sliding_window_view(xa, W)[pos]
        wm = np.lib.stride_tricks.sliding_window_view(ma, W)[pos]
        cnt = wm.sum(axis=1)
        ok = cnt > 0
        cntc = np.maximum(cnt, 1)
        if self.op == "sum":
            val = win.sum(axis=1)
        elif self.op == "mean":
            val = win.sum(axis=1) / cntc
        elif self.op == "stddev":
            mu = win.sum(axis=1) / cntc
            val = np.sqrt(np.maximum((win**2).sum(axis=1) / cntc - mu**2, 0))
        elif self.op == "rms":
            val = np.sqrt((win**2).sum(axis=1) / cntc)
        elif self.op == "max":
            val = np.where(wm, win, -np.inf).max(axis=1)
        elif self.op == "min":
            val = np.where(wm, win, np.inf).min(axis=1)
        elif self.op == "absmax":
            val = np.where(wm, np.abs(win), -np.inf).max(axis=1)
        elif self.op == "kurtosis":
            mu1 = win.sum(1) / cntc
            m2 = (win**2).sum(1) / cntc - mu1**2
            m4 = ((win**4).sum(1) / cntc - 4 * mu1 * (win**3).sum(1) / cntc
                  + 6 * mu1**2 * (win**2).sum(1) / cntc - 3 * mu1**4)
            val = m4 / np.maximum(m2 * m2, 1e-30)
        elif self.op == "count":
            val = cnt.astype(np.float64)
        else:  # pragma: no cover
            raise KeyError(self.op)
        self._tail_v = xa[len(xa) - (W - 1):]
        self._tail_m = ma[len(ma) - (W - 1):]
        self._tick += n
        return Batch(out_ts, val, ok)


class Join(Operator):
    """Strict-overlap temporal join of two aligned regular streams.

    Events join when both sides are valid at the same tick (searchsorted
    timestamp alignment — the hash-on-interval equivalent for grid streams).
    """

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, left: Batch, right: Batch) -> Batch:
        # align right events onto left timestamps (hold semantics)
        idx = np.searchsorted(right.ts, left.ts, side="right") - 1
        ok_idx = idx >= 0
        idx_c = np.clip(idx, 0, len(right.ts) - 1)
        rv = _take_cols(right.value, idx_c)
        rm = right.valid[idx_c] & ok_idx
        ok = left.valid & rm
        return Batch(left.ts, self.fn(left.value, rv), ok)


class Coalesce(Operator):
    def __call__(self, left: Batch, right: Batch) -> Batch:
        idx = np.clip(np.searchsorted(right.ts, left.ts, side="right") - 1,
                      0, len(right.ts) - 1)
        rv = _take_cols(right.value, idx)
        rm = right.valid[idx]
        val = np.where(left.valid, np.asarray(left.value), np.asarray(rv))
        return Batch(left.ts, val, left.valid | rm)


class InterpOp(Operator):
    """Linear-interpolation resampling onto a new tick period.

    Lookahead operator: output ticks within ``max_gap`` of the watermark
    (latest seen timestamp) are withheld until the next batch (or
    :meth:`flush`) provides their right-hand neighbour — the cross-batch
    state an event-centric engine must hand-manage for every such operator.
    """

    def __init__(self, in_prec: int, out_prec: int, max_gap: int):
        self.p, self.q, self.g = in_prec, out_prec, max_gap
        self.reset()

    def reset(self):
        self._tail_ts = np.zeros(0, np.int64)   # valid events ≤ g behind hi
        self._tail_x = np.zeros(0)
        self._next_out = self.q                 # next output tick to emit

    def _emit(self, ts_v, xs, upto: int) -> Batch:
        out_ts = np.arange(self._next_out, upto + 1, self.q)
        self._next_out = (out_ts[-1] + self.q) if len(out_ts) else self._next_out
        if len(ts_v) == 0:
            return Batch(out_ts, np.zeros(len(out_ts)),
                         np.zeros(len(out_ts), bool))
        val = np.interp(out_ts, ts_v, xs)
        i0 = np.clip(np.searchsorted(ts_v, out_ts, "right") - 1, 0,
                     len(ts_v) - 1)
        i1 = np.clip(np.searchsorted(ts_v, out_ts, "left"), 0, len(ts_v) - 1)
        ok = ((out_ts - ts_v[i0] <= self.g) & (ts_v[i1] - out_ts <= self.g)
              & (ts_v[i0] <= out_ts) & (ts_v[i1] >= out_ts))
        return Batch(out_ts, val, ok)

    def __call__(self, b: Batch) -> Batch:
        ts_v = np.concatenate([self._tail_ts, b.ts[b.valid]])
        xs = np.concatenate([self._tail_x, np.asarray(b.value)[b.valid]])
        hi = b.ts[-1] if len(b.ts) else (
            self._tail_ts[-1] if len(self._tail_ts) else 0)
        out = self._emit(ts_v, xs, hi - self.g)
        keep = ts_v >= hi - 2 * self.g  # enough left-context for held ticks
        self._tail_ts, self._tail_x = ts_v[keep], xs[keep]
        return out

    def flush(self) -> Optional[Batch]:
        if len(self._tail_ts) == 0:
            return None
        return self._emit(self._tail_ts, self._tail_x, self._tail_ts[-1])


class Pipeline:
    """Interpreted operator DAG runner (operator-at-a-time per micro-batch).

    ``steps`` is a list of (op, input names, output name); 'in' is the source
    batch.  Every intermediate batch materializes into ``env`` — the
    message-queue hand-off the paper's §3 identifies as the interpreted-SPE
    bottleneck.
    """

    def __init__(self, steps: Sequence[tuple]):
        self.steps = steps

    def reset(self):
        for op, _, _ in self.steps:
            op.reset()

    def run_batch(self, env: dict) -> Batch:
        out = None
        for op, ins, name in self.steps:
            args = [env[i] for i in ins]
            out = op(*args)
            env[name] = out
        return out

    def run(self, batches, key: str = "in") -> list[Batch]:
        self.reset()
        outs = []
        for b in batches:
            env = {key: b} if isinstance(b, Batch) else dict(b)
            outs.append(self.run_batch(env))
        # flush lookahead operators (tail emission at stream end)
        for op, _, _ in self.steps:
            fl = getattr(op, "flush", None)
            if fl is not None:
                tail = fl()
                if tail is not None and len(tail):
                    outs.append(tail)
        return outs


# ---------------------------------------------------------------------------
# column helpers (payload may be an array or a dict of arrays)
# ---------------------------------------------------------------------------

def _zeros_like_cols(v, n):
    if isinstance(v, dict):
        return {k: np.zeros((n,) + a.shape[1:], a.dtype) for k, a in v.items()}
    return np.zeros((n,) + np.asarray(v).shape[1:], np.asarray(v).dtype)


def _concat_cols(a, b):
    if isinstance(a, dict):
        return {k: np.concatenate([a[k], b[k]]) for k in a}
    return np.concatenate([a, b])


def _slice_cols(v, lo, hi):
    if isinstance(v, dict):
        return {k: a[lo:hi] for k, a in v.items()}
    return v[lo:hi]


def _take_cols(v, idx):
    if isinstance(v, dict):
        return {k: a[idx] for k, a in v.items()}
    return np.asarray(v)[idx]
