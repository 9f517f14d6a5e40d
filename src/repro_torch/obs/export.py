"""Snapshot exporters: JSONL stream and Prometheus text exposition; port
of ``repro.obs.export`` (pure Python, the same schema).

Both consume the plain dict produced by ``Metrics.snapshot()`` — never a
live registry — so exporting is always off the hot path and the snapshot
schema is the exporters' only contract:

``repro.obs/v1`` snapshot schema::

    {
      "schema": "repro.obs/v1",
      "ts": <unix seconds, float>,
      "counters":   {name: {"value": num, "help": str, "unit": str}},
      "gauges":     {name: {"value": num, "help": str, "unit": str}},
      "histograms": {name: {"edges": [f...], "counts": [i...],   # len(edges)+1,
                            "count": i, "sum": f,                 # last = +Inf overflow
                            "p50": f|null, "p90": f|null, "p99": f|null,
                            "help": str, "unit": str}},
      "vectors":    {name: {"labels": [s...], "values": [i...],
                            "help": str, "unit": str}},
      "spans":      {path: {"count": i, "total_s": f, "max_s": f}},
      "compiles":   {"counts": {key: i}, "retraces": {key: i}},
    }

``export_jsonl`` appends one compact line per snapshot (a time series a
dashboard can tail); ``export_prometheus`` renders the Prometheus text
exposition format (histograms become cumulative ``_bucket{le=...}`` plus
``_sum``/``_count``, vectors become one labelled sample per slot).
``validate_snapshot`` is the schema smoke the tests share.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, List

from .metrics import SCHEMA

__all__ = ["export_jsonl", "read_jsonl", "export_prometheus",
           "validate_snapshot"]


def export_jsonl(snap: Dict, path: str) -> None:
    """Append one snapshot as one JSON line."""
    with open(path, "a") as f:
        f.write(json.dumps(snap, sort_keys=True) + "\n")


def read_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_num(v) -> str:
    if v is None:
        return "NaN"
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if isinstance(v, float) else str(v)


def export_prometheus(snap: Dict) -> str:
    """Render a snapshot in the Prometheus text exposition format."""
    lines: List[str] = []

    def header(name, help, kind):
        if help:
            lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {kind}")

    for name, m in snap.get("counters", {}).items():
        pn = _prom_name(name) + "_total"
        header(pn, m.get("help", ""), "counter")
        lines.append(f"{pn} {_prom_num(m['value'])}")
    for name, m in snap.get("gauges", {}).items():
        pn = _prom_name(name)
        header(pn, m.get("help", ""), "gauge")
        lines.append(f"{pn} {_prom_num(m['value'])}")
    for name, m in snap.get("vectors", {}).items():
        pn = _prom_name(name) + "_total"
        header(pn, m.get("help", ""), "counter")
        for label, v in zip(m["labels"], m["values"]):
            lines.append(f'{pn}{{slot="{label}"}} {v}')
    for name, m in snap.get("histograms", {}).items():
        pn = _prom_name(name)
        header(pn, m.get("help", ""), "histogram")
        cum = 0
        for edge, c in zip(m["edges"] + [float("inf")], m["counts"]):
            cum += c
            lines.append(f'{pn}_bucket{{le="{_prom_num(float(edge))}"}} {cum}')
        lines.append(f"{pn}_sum {_prom_num(m['sum'])}")
        lines.append(f"{pn}_count {m['count']}")
    for path, s in snap.get("spans", {}).items():
        pn = _prom_name("span_" + path)
        lines.append(f"{pn}_seconds_total {_prom_num(s['total_s'])}")
        lines.append(f"{pn}_count {s['count']}")
    for key, n in snap.get("compiles", {}).get("counts", {}).items():
        lines.append(f'compiles_total{{key="{_prom_name(key)}"}} {n}')
    return "\n".join(lines) + "\n"


def validate_snapshot(snap: Dict) -> List[str]:
    """Return schema problems (empty list == valid ``repro.obs/v1``)."""
    bad: List[str] = []
    if not isinstance(snap, dict):
        return ["snapshot is not a dict"]
    if snap.get("schema") != SCHEMA:
        bad.append(f"schema is {snap.get('schema')!r}, want {SCHEMA!r}")
    if not isinstance(snap.get("ts"), (int, float)):
        bad.append("ts missing or non-numeric")
    for sec in ("counters", "gauges", "histograms", "vectors", "spans"):
        if not isinstance(snap.get(sec), dict):
            bad.append(f"{sec} missing or not a dict")
    for name, m in snap.get("counters", {}).items():
        if not isinstance(m.get("value"), (int, float)):
            bad.append(f"counter {name}: value missing")
    for name, m in snap.get("gauges", {}).items():
        if not isinstance(m.get("value"), (int, float, list)):
            bad.append(f"gauge {name}: value missing")
    for name, m in snap.get("histograms", {}).items():
        edges, counts = m.get("edges"), m.get("counts")
        if not isinstance(edges, list) or not isinstance(counts, list):
            bad.append(f"histogram {name}: edges/counts missing")
            continue
        if len(counts) != len(edges) + 1:
            bad.append(f"histogram {name}: want {len(edges) + 1} counts "
                       f"(incl. overflow), got {len(counts)}")
        if edges != sorted(edges):
            bad.append(f"histogram {name}: edges not ascending")
        if m.get("count") != sum(counts):
            bad.append(f"histogram {name}: count != sum(counts)")
        for q in ("p50", "p90", "p99"):
            if q not in m:
                bad.append(f"histogram {name}: {q} missing")
    for name, m in snap.get("vectors", {}).items():
        if len(m.get("labels", [])) != len(m.get("values", ())):
            bad.append(f"vector {name}: labels/values length mismatch")
    comp = snap.get("compiles")
    if not isinstance(comp, dict) or "counts" not in comp \
            or "retraces" not in comp:
        bad.append("compiles missing counts/retraces")
    return bad
