"""repro_torch.obs — zero-sync runtime telemetry for the execution stack
(port of ``repro.obs``).

Three pillars:

* :mod:`repro_torch.obs.metrics` — device-resident counters / gauges /
  histograms / labelled vectors behind one registry.  Accumulating never
  syncs; ``Metrics.snapshot()`` is the single device→host read.
* :mod:`repro_torch.obs.trace` — wall-time span trees
  (``metrics.tracer.span("plan")``) and the per-policy-point recompile
  detector fed by the runner's ``step_cache`` misses.
* :mod:`repro_torch.obs.export` — schema-versioned (``repro.obs/v1``) JSONL
  and Prometheus text sinks over snapshots, plus ``validate_snapshot``.
"""
from .metrics import (SCHEMA, Counter, Gauge, Histogram, Metrics,
                      VectorCounter, counter_delta, default, disabled,
                      log_buckets)
from .trace import Tracer
from .export import (export_jsonl, export_prometheus, read_jsonl,
                     validate_snapshot)

__all__ = [
    "SCHEMA", "Counter", "Gauge", "Histogram", "VectorCounter", "Metrics",
    "Tracer", "default", "disabled", "log_buckets", "counter_delta",
    "export_jsonl", "export_prometheus", "read_jsonl", "validate_snapshot",
]
