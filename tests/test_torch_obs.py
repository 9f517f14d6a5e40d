"""The port's telemetry (``repro_torch.obs``) against the reference's
(``repro.obs``): the metric types, tracer and exporters in isolation, as
``tests/test_obs.py`` covers them, with device parts held as torch
tensors; plus the cross-package contract — the port's snapshots pass the
reference's ``validate_snapshot``, and the same updates render the same
Prometheus text in both packages.  Everything here is exact (integers and
the same float arithmetic on the host)."""
import json
import math
import os

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro_torch import obs
from repro_torch.obs import (Metrics, counter_delta, disabled, export_jsonl,
                             export_prometheus, log_buckets, read_jsonl,
                             validate_snapshot)


def test_registry_get_or_create_and_type_guard():
    m = Metrics()
    c = m.counter("x.count", "help text", "items")
    assert m.counter("x.count") is c
    assert m.get("x.count") is c and m.get("missing") is None
    with pytest.raises(ValueError):
        m.gauge("x.count")
    m.drop("x.count")
    assert m.get("x.count") is None


def test_counter_host_device_and_pending_adds():
    c = Metrics().counter("c")
    c.add(2)
    c.add(3)
    assert c.value == 5
    # tensor scalars queue as pending references (no eager device add)
    c.add(torch.tensor(7, dtype=torch.int32))
    c.add(torch.tensor(1, dtype=torch.int32))
    assert c._pending and c.value == 13
    c.fold_device()
    assert c._base == 13 and not c._pending and c._dev is None
    c.set_device(torch.tensor(4, dtype=torch.int32))
    assert c.value == 17
    c.reset()
    assert c.value == 0


def test_counter_pending_collapse_stays_lazy():
    c = Metrics().counter("c")
    for _ in range(c._COLLAPSE + 5):
        c.add(torch.tensor(1, dtype=torch.int32))
    assert c._dev is not None and len(c._pending) == 5
    assert c.value == c._COLLAPSE + 5


def test_gauge_and_vector():
    m = Metrics()
    g = m.gauge("g")
    g.set(2.5)
    assert g.value == 2.5
    v = m.vector("v", labels=["64", "128", "256"])
    v.add(1)
    v.add(1, 4)
    v.set_device(torch.tensor([1, 0, 2], dtype=torch.int32))
    assert v.values == [1, 5, 2]
    v.fold_device()
    assert v.values == [1, 5, 2]


def test_histogram_bucketing_quantiles_and_device_counts():
    m = Metrics()
    h = m.histogram("h", edges=[1.0, 2.0, 4.0])
    for x in (0.5, 1.5, 1.5, 3.0, 100.0):
        h.observe(x)
    assert list(h.counts()) == [1, 2, 1, 1]
    snap = h.to_snapshot()
    assert snap["count"] == 5 and snap["sum"] == pytest.approx(106.5)
    assert snap["p99"] == 4.0 and 1.0 <= snap["p50"] <= 2.0
    h.set_device(torch.tensor([0, 0, 3, 0], dtype=torch.int32))
    assert list(h.counts()) == [1, 2, 4, 1]
    h.fold_device()
    assert list(h.counts()) == [1, 2, 4, 1] and h._dev is None


def test_log_histogram_quantile_interpolates_geometrically():
    m = Metrics()
    edges = log_buckets(1e-4, 1.0, per_decade=1)
    assert edges == robs.log_buckets(1e-4, 1.0, per_decade=1)
    h = m.histogram("lat", edges=edges, log_scale=True)
    for _ in range(100):
        h.observe(3e-3)
    assert math.isclose(h.quantile(0.5), 1e-3 * 10 ** 0.5, rel_tol=1e-6)
    assert m.histogram("lat", edges=edges) is h
    with pytest.raises(ValueError):
        Metrics().histogram("bad", edges=[2.0, 1.0])
    assert Metrics().histogram("e", edges=[1.0]).quantile(0.5) is None


def test_disabled_makes_updates_noops():
    m = Metrics()
    c, g = m.counter("c"), m.gauge("g")
    h = m.histogram("h", edges=[1.0])
    with disabled():
        c.add(5)
        g.set(9)
        h.observe(0.5)
        assert not m.on
    assert c.value == 0 and g.value == 0 and int(h.counts().sum()) == 0
    assert m.on
    m.enabled = False
    assert not m.on


def test_counter_delta_and_collectors():
    m = Metrics()
    c = m.counter("c")
    c.add(2)
    s0 = m.snapshot()
    c.add(5)
    s1 = m.snapshot()
    assert counter_delta(s0, s1, "c") == 5
    assert counter_delta(s0, s1, "absent") == 0
    m.register_collector("derived", lambda: m.gauge("d").set(42))
    assert m.snapshot()["gauges"]["d"]["value"] == 42
    m.register_collector("derived", lambda: m.gauge("d").set(7))
    assert m.snapshot()["gauges"]["d"]["value"] == 7


def test_tracer_spans_compiles_and_retraces():
    t = Metrics().tracer
    with t.span("rebuild"):
        with t.span("plan"):
            pass
        with t.span("plan"):
            pass
    rep = t.span_report()
    assert rep["rebuild"]["count"] == 1 and rep["rebuild/plan"]["count"] == 2
    t.record_compile("step(a)")
    t.record_compile("step(b)")
    t.record_compile("step(b)")
    assert t.compiles() == {"step(a)": 1, "step(b)": 2}
    assert t.retraces() == {"step(b)": 1}
    assert t.retrace_findings()[0]["code"] == "runtime-retrace"


def test_span_opens_a_profiler_range_under_the_env_switch(monkeypatch):
    monkeypatch.setenv("REPRO_OBS_JAX_TRACE", "1")
    t = Metrics().tracer
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("chunk"):
            torch.ones(3).sum()
    assert any(e.name == "chunk" for e in prof.events())


def _fill(m, tensor):
    """The same updates on either package's registry; device parts come
    from ``tensor`` (a torch or jax constructor)."""
    m.counter("runner.chunks", "chunks stepped").add(3)
    m.counter("runner.dirty_units", "units", "units").set_device(
        tensor([7], "int32")[0])
    m.gauge("runner.compact").set(0.25)
    h = m.histogram("runner.step_seconds", log_buckets(1e-4, 1.0, 2),
                    "per-chunk latency", "s", log_scale=True)
    h.observe(2e-3)
    h.observe(8e-3)
    m.histogram("runner.dirty_fraction", [0.5, 1.0]).set_device(
        tensor([1, 2, 0], "int32"))
    v = m.vector("runner.bucket_picks", labels=["1", "2", "4"])
    v.add(2, 5)
    v.set_device(tensor([1, 0, 0], "int32"))
    with m.tracer.span("chunk"):
        pass
    m.tracer.record_compile("sparse_fused(K=1,segs=4,True)")
    return m


def _torch_t(x, dt):
    return torch.tensor(x, dtype=getattr(torch, dt))


def _jax_t(x, dt):
    import jax.numpy as jnp
    return jnp.asarray(x, dtype=dt)


def _stable(snap):
    """A snapshot without its wall-time fields (timestamps, span seconds)."""
    s = json.loads(json.dumps(snap))
    s.pop("ts")
    s["spans"] = {k: v["count"] for k, v in s["spans"].items()}
    return s


def test_port_snapshot_passes_the_reference_validator():
    snap = _fill(Metrics(), _torch_t).snapshot()
    assert snap["schema"] == obs.SCHEMA == robs.SCHEMA
    assert robs.validate_snapshot(snap) == []
    assert validate_snapshot(snap) == []
    assert snap["counters"]["runner.dirty_units"]["value"] == 7
    assert snap["vectors"]["runner.bucket_picks"]["values"] == [1, 0, 5]
    # and the validators agree on a broken one
    bad = json.loads(json.dumps(snap))
    bad["histograms"]["runner.step_seconds"]["counts"].append(1)
    assert validate_snapshot(bad) == robs.validate_snapshot(bad) != []


def test_same_updates_same_snapshot_and_prometheus_text():
    port = _fill(Metrics(), _torch_t).snapshot()
    ref = _fill(robs.Metrics(), _jax_t).snapshot()
    assert _stable(port) == _stable(ref)
    pt, rt = export_prometheus(port), robs.export_prometheus(ref)
    strip = lambda text: [ln for ln in text.splitlines()  # noqa: E731
                          if not ln.startswith("span_")]
    assert strip(pt) == strip(rt)
    assert 'runner_step_seconds_bucket{le="+Inf"} 2' in pt
    assert 'compiles_total{key="sparse_fused_K_1_segs_4_True_"} 1' in pt


def test_jsonl_round_trip_readable_by_both_packages(tmp_path):
    m = _fill(Metrics(), _torch_t)
    path = os.path.join(tmp_path, "metrics.jsonl")
    snap = m.snapshot()
    export_jsonl(snap, path)
    export_jsonl(m.snapshot(), path)
    back = read_jsonl(path)
    assert len(back) == 2 and back[0] == json.loads(json.dumps(snap))
    assert robs.read_jsonl(path) == back
    assert robs.validate_snapshot(back[1]) == []


def test_reset_and_reset_after_warmup():
    m = _fill(Metrics(), _torch_t)
    calls = []
    m.register_warmup_reset("svc", lambda: calls.append("svc"))
    m.register_warmup_reset("svc", lambda: calls.append("svc2"))
    m.reset_after_warmup()
    assert calls == ["svc2"]
    snap = m.snapshot()
    assert snap["counters"]["runner.chunks"]["value"] == 0
    assert snap["vectors"]["runner.bucket_picks"]["values"] == [0, 0, 0]
    assert snap["compiles"]["counts"] == {"sparse_fused(K=1,segs=4,True)": 1}
    m.reset()
    snap = m.snapshot()
    assert snap["compiles"]["counts"] == {} and snap["spans"] == {}
    assert np.isclose(snap["histograms"]["runner.step_seconds"]["sum"], 0.0)
