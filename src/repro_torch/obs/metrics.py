"""Device-resident runtime metrics (the accumulate-vs-read sync contract);
port of ``repro.obs.metrics``.

The engine needs to observe itself — dirty fractions, bucket picks, chunk
latencies, compile counts — without adding a device→host transfer to a
steady-state chunk (a dense chunk issues none, a sparse one only the read
of its dirty count).  The registry here is built around one contract:

* **Accumulating never syncs.**  Hot-path updates are either pure host
  arithmetic (Python ints, numpy bincounts — no device involvement at
  all) or *lazy device arithmetic*: a :class:`Counter` /
  :class:`VectorCounter` / :class:`Histogram` can hold a tensor as its
  device part, and updates just extend the device-side computation
  (``dev = dev + x``) or swap in a reference to a device tensor that the
  runner's accumulator updates in place (:meth:`Counter.set_device`).
  Neither issues a device→host read.
* **Reading syncs, once, explicitly.**  :meth:`Metrics.snapshot` is the
  single device→host boundary: it resolves every device part to a host
  number (``.cpu()``, here and nowhere else) and returns a plain-Python, schema-versioned dict
  (``SCHEMA``).  Exporters (:mod:`repro.obs.export`) consume snapshots,
  never live metrics.

Metric types
------------

``Counter``
    Monotonic count.  ``add()`` takes host numbers or device scalars;
    the runner's accumulator instead calls ``set_device`` with the
    running device total (see ``engine/runner.py``).
``Gauge``
    Last-set value (host or device).
``Histogram``
    Fixed-bucket distribution.  Host observations (``observe`` — e.g.
    wall-clock step latency) land in a numpy bincount; device
    observations arrive as a counts vector via ``set_device``.  Quantiles
    (p50/p90/p99) are estimated at snapshot time by interpolating the
    cumulative counts inside the hit bucket — log-linear for log-scale
    buckets (:func:`log_buckets`), linear otherwise.
``VectorCounter``
    A labelled vector of counts (e.g. capacity-bucket picks, one slot per
    ladder rung), host or device.

The module-level :func:`default` registry serves instrumentation points
that have no object to hang a registry on (one-shot ``sparse_run``, the
halo-exchange entry points); engine objects (``Runner``,
``MultiQuerySession``) own their registry so telemetry scopes to the
stream it describes.  :func:`disabled` turns every update into a no-op,
for measuring what the instrumentation costs.
"""
from __future__ import annotations

import bisect
import contextlib
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["SCHEMA", "Counter", "Gauge", "Histogram", "VectorCounter",
           "Metrics", "default", "disabled", "log_buckets",
           "counter_delta"]

SCHEMA = "repro.obs/v1"

_ENABLED = [True]  # module-wide kill switch (see disabled())


@contextlib.contextmanager
def disabled():
    """Context manager: every metric update in scope is a no-op (the
    registry objects survive; their values simply don't move).  Used to
    measure instrumentation overhead."""
    _ENABLED.append(False)
    try:
        yield
    finally:
        _ENABLED.pop()


def _on() -> bool:
    return _ENABLED[-1]


def _to_host(x):
    """Resolve a possibly-device value to a host Python number (the one
    sync point, only ever reached from snapshot())."""
    if x is None:
        return 0
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.item() if a.ndim == 0 else a


def log_buckets(lo: float, hi: float, per_decade: int = 3
                ) -> List[float]:
    """Log-scale bucket upper edges covering [lo, hi] with ``per_decade``
    buckets per decade (plus the implicit +Inf overflow bucket)."""
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (k / per_decade) for k in range(n + 1)]


class Counter:
    """Monotonic counter with a host part and an optional lazy device
    part.  ``value`` = host base + device accumulation (syncs)."""

    # device adds are deferred into a pending list (a reference append:
    # an eager device ``+`` costs a kernel launch per add); the list
    # collapses into one batched device op per this many adds
    _COLLAPSE = 128

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name, self.help, self.unit = name, help, unit
        self._base = 0
        self._dev = None
        self._pending: List = []

    def add(self, v=1) -> None:
        """Accumulate. Host numbers add into the base; tensors are queued
        for a lazy batched device sum (no sync, no launch)."""
        if not _on():
            return
        if isinstance(v, (int, float, np.integer, np.floating)):
            self._base += v
        else:
            self._pending.append(v)
            if len(self._pending) >= self._COLLAPSE:
                self._collapse()

    def _collapse(self) -> None:
        """Fold the pending device adds into the lazy device total —
        device-side arithmetic (amortized to one op per _COLLAPSE adds),
        still no device→host sync."""
        if not self._pending:
            return
        try:
            tot = torch.stack(self._pending).sum()
        except (RuntimeError, TypeError):  # mixed shapes/dtypes
            tot = self._pending[0]
            for x in self._pending[1:]:
                tot = tot + x
        self._dev = tot if self._dev is None else self._dev + tot
        self._pending = []

    def set_device(self, x) -> None:
        """Swap in the running device total (owned by the runner's
        accumulator — see engine/runner.py).  A reference assignment:
        no launch, no sync."""
        if _on():
            self._dev = x

    def fold_device(self) -> None:
        """Sync the device part into the host base and drop the
        reference — called off-path when the device accumulation chain
        is about to be replaced (e.g. a session rebuilding its runner)."""
        for x in self._pending:
            self._base += _to_host(x)
        self._pending = []
        if self._dev is not None:
            self._base += _to_host(self._dev)
            self._dev = None

    def reset(self) -> None:
        self._base, self._dev, self._pending = 0, None, []

    @property
    def value(self):
        """Current total (syncs the device part)."""
        return (self._base + _to_host(self._dev)
                + sum(_to_host(x) for x in self._pending))

    def to_snapshot(self) -> Dict:
        return {"value": self.value, "help": self.help, "unit": self.unit}


class Gauge:
    """Last-set value (host number or device scalar)."""

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name, self.help, self.unit = name, help, unit
        self._v = 0

    def set(self, v) -> None:
        if _on():
            self._v = v

    def reset(self) -> None:
        self._v = 0

    @property
    def value(self):
        return _to_host(self._v)

    def to_snapshot(self) -> Dict:
        return {"value": self.value, "help": self.help, "unit": self.unit}


class VectorCounter:
    """A labelled vector of counts (one slot per label), host numpy base
    plus an optional device counts vector."""

    def __init__(self, name: str, labels: Sequence[str], help: str = "",
                 unit: str = ""):
        self.name, self.help, self.unit = name, help, unit
        self.labels = [str(x) for x in labels]
        self._base = np.zeros(len(self.labels), np.int64)
        self._dev = None

    def add(self, idx: int, v=1) -> None:
        if _on():
            self._base[idx] += v

    def set_device(self, counts) -> None:
        if _on():
            self._dev = counts

    def fold_device(self) -> None:
        if self._dev is not None:
            self._base = self._base + _to_host(self._dev)
            self._dev = None

    def reset(self) -> None:
        self._base = np.zeros(len(self.labels), np.int64)
        self._dev = None

    @property
    def values(self) -> List[int]:
        tot = self._base if self._dev is None \
            else self._base + _to_host(self._dev)
        return [int(x) for x in tot]

    def to_snapshot(self) -> Dict:
        return {"labels": list(self.labels), "values": self.values,
                "help": self.help, "unit": self.unit}


class Histogram:
    """Fixed-bucket histogram: ``edges`` are ascending upper bounds, with
    an implicit +Inf overflow bucket (``len(edges) + 1`` counts total).

    Host observations (:meth:`observe`) are a numpy bincount update —
    no device involvement.  Device distributions (e.g. the per-chunk
    dirty-fraction histogram the runner accumulates on the device)
    arrive whole via :meth:`set_device`.  Quantiles interpolate
    inside the hit bucket: log-linearly when ``log_scale`` (latency
    buckets), linearly otherwise.
    """

    def __init__(self, name: str, edges: Sequence[float], help: str = "",
                 unit: str = "", log_scale: bool = False):
        if list(edges) != sorted(edges) or len(edges) < 1:
            raise ValueError(f"histogram {name}: edges must be ascending")
        self.name, self.help, self.unit = name, help, unit
        self.edges = [float(e) for e in edges]
        self.log_scale = log_scale
        self._counts = np.zeros(len(self.edges) + 1, np.int64)
        self._sum = 0.0
        self._dev = None  # device counts vector (len(edges) + 1)

    def observe(self, v: float) -> None:
        """Record one host-side observation (pure host arithmetic)."""
        if not _on():
            return
        self._counts[bisect.bisect_left(self.edges, v)] += 1
        self._sum += v

    def set_device(self, counts) -> None:
        """Swap in the running device counts vector (shape
        ``(len(edges) + 1,)``)."""
        if _on():
            self._dev = counts

    def fold_device(self) -> None:
        if self._dev is not None:
            self._counts = self._counts + _to_host(self._dev)
            self._dev = None

    def reset(self) -> None:
        self._counts = np.zeros(len(self.edges) + 1, np.int64)
        self._sum = 0.0
        self._dev = None

    def counts(self) -> np.ndarray:
        return (self._counts if self._dev is None
                else self._counts + _to_host(self._dev))

    def quantile(self, q: float, counts: Optional[np.ndarray] = None
                 ) -> Optional[float]:
        """Estimated q-quantile from the bucket counts (None when
        empty).  Overflow-bucket hits clamp to the top edge."""
        c = self.counts() if counts is None else counts
        total = int(c.sum())
        if total == 0:
            return None
        target = q * total
        cum = 0
        for i, n in enumerate(c):
            if n == 0:
                continue
            if cum + n >= target:
                frac = (target - cum) / n
                if i >= len(self.edges):          # overflow bucket
                    return self.edges[-1]
                hi = self.edges[i]
                lo = self.edges[i - 1] if i > 0 else (
                    hi / 10 if self.log_scale else 0.0)
                if self.log_scale and lo > 0:
                    return lo * (hi / lo) ** frac
                return lo + (hi - lo) * frac
            cum += n
        return self.edges[-1]

    def to_snapshot(self) -> Dict:
        c = self.counts()
        out = {"edges": list(self.edges), "counts": [int(x) for x in c],
               "count": int(c.sum()), "sum": float(self._sum),
               "help": self.help, "unit": self.unit}
        for q in (0.5, 0.9, 0.99):
            out[f"p{int(q * 100)}"] = self.quantile(q, c)
        return out


class Metrics:
    """A named registry of metrics plus an attached span tracer.

    ``counter`` / ``gauge`` / ``histogram`` / ``vector`` are
    get-or-create: instrumentation points just name the metric they want
    and shared registries (a session and the runner it builds) land in
    the same slot.  :meth:`snapshot` is the one device→host read.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: Dict[str, object] = {}
        self._collectors: Dict[str, Callable[[], None]] = {}
        self._warmup_hooks: Dict[str, Callable[[], None]] = {}
        from .trace import Tracer
        self.tracer = Tracer()

    @property
    def on(self) -> bool:
        return self.enabled and _on()

    def _get(self, cls, name, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, *args, **kw)
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def get(self, name: str):
        """The registered metric object under ``name``, or None."""
        return self._metrics.get(name)

    def drop(self, name: str) -> None:
        """Forget a metric (e.g. before re-registering with a different
        shape — a runner rebuilt at a new geometry)."""
        self._metrics.pop(name, None)

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get(Gauge, name, help, unit)

    def vector(self, name: str, labels: Sequence[str], help: str = "",
               unit: str = "") -> VectorCounter:
        return self._get(VectorCounter, name, labels, help, unit)

    def histogram(self, name: str, edges: Sequence[float], help: str = "",
                  unit: str = "", log_scale: bool = False) -> Histogram:
        return self._get(Histogram, name, edges, help, unit,
                         log_scale=log_scale)

    def register_collector(self, name: str, fn: Callable[[], None]) -> None:
        """Register a pre-snapshot hook (e.g. a runner pushing derived
        gauges).  Re-registering a name replaces the old hook — the
        session-rebuild path, where the new runner supersedes the old."""
        self._collectors[name] = fn

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()
        self.tracer.reset()

    def register_warmup_reset(self, name: str,
                              fn: Callable[[], None]) -> None:
        """Register a :meth:`reset_after_warmup` hook (e.g. a runner
        re-basing its device accumulator).  Re-registering a name replaces
        the old hook, mirroring :meth:`register_collector`."""
        self._warmup_hooks[name] = fn

    def reset_after_warmup(self) -> None:
        """Re-base the registry at the end of warmup so long-lived
        services window percentiles past the compiling first chunks:
        every metric's measured values reset (the latency histogram in
        particular), then registered warmup hooks run so device-
        accumulator owners (``Runner._mstate``) drop their state and
        re-assert static gauges.

        The tracer is deliberately **not** reset: its per-key compile
        counts are exactly the warmup record the recompile detector needs
        — a post-warmup compile of an already-seen staging key must still
        show up as a retrace."""
        for m in self._metrics.values():
            m.reset()
        for fn in list(self._warmup_hooks.values()):
            fn()

    def snapshot(self) -> Dict:
        """Resolve every metric to host values: the single explicit
        device→host boundary.  Returns a schema-versioned plain dict
        (see :mod:`repro.obs.export` for the schema contract)."""
        for fn in list(self._collectors.values()):
            fn()
        snap = {"schema": SCHEMA, "ts": time.time(),
                "counters": {}, "gauges": {}, "histograms": {},
                "vectors": {}}
        for name, m in sorted(self._metrics.items()):
            kind = {Counter: "counters", Gauge: "gauges",
                    Histogram: "histograms",
                    VectorCounter: "vectors"}[type(m)]
            snap[kind][name] = m.to_snapshot()
        snap["spans"] = self.tracer.span_report()
        snap["compiles"] = self.tracer.compile_report()
        return snap


_DEFAULT: Optional[Metrics] = None


def default() -> Metrics:
    """The process-global registry, serving instrumentation points with
    no natural owner (one-shot entry points, halo exchange staging)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Metrics()
    return _DEFAULT


def counter_delta(before: Dict, after: Dict, name: str):
    """Counter difference between two snapshots (0 when absent in both)."""
    get = lambda s: s.get("counters", {}).get(name, {}).get("value", 0)  # noqa: E731
    return get(after) - get(before)
