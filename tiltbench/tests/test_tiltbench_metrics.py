"""The metric arithmetic: the rate over the whole window, percentiles over
every sample, the readers' silence where there is nothing to read, and the
sample of chunks the comparison draws."""
import importlib.util
from pathlib import Path

from tiltbench import harness

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _read(name, ctx):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _ctx(**kw):
    base = dict(loop="closed", setup_s=12.5, chunks=10,
                window_s=2.0, keyticks_per_chunk=100, latencies_s=[],
                step_host_s=0.05, chunk_bytes=335_000_000, sparse=True,
                units=16)
    base.update(kw)
    return harness.Ctx(**base)


def test_percentile_over_every_sample():
    xs = [float(i) for i in range(1, 101)]
    assert harness.percentile(xs, 50) == 50.5
    assert abs(harness.percentile(xs, 95) - 95.05) < 1e-12
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.percentile(list(reversed(xs)), 100) == 100.0


def test_end_to_end_readers():
    ctx = _ctx()
    assert _read("keyticks_per_s", ctx) == 10 * 100 / 2.0
    assert _read("setup_s", ctx) == 12.5
    assert _read("result_p95_ms", ctx) is None
    op = _ctx(loop="open", latencies_s=[i / 1000 for i in range(1, 101)])
    assert _read("keyticks_per_s", op) is None
    assert abs(_read("result_p95_ms", op) - 95.05) < 1e-9
    assert abs(_read("result_p50_ms", op) - 50.5) < 1e-9


def test_per_layer_readers():
    ctx = _ctx()
    assert abs(_read("step_host_ms.tput", ctx) - 5.0) < 1e-12
    assert _read("step_host_ms.rate", ctx) is None
    # 335 MB at 3.35 TB/s is 0.1 ms, over 0.2 ms a chunk
    assert abs(_read("chunk_roofline_pct", _ctx(window_s=2e-3)) - 50.0) \
        < 1e-9
    assert _read("units_computed_pct", ctx) is None
    ctx.dirty = {"chunks": 10, "units": 160, "dirty_units": 24,
                 "compact": 0.15}
    ctx.picks = {1: 0, 2: 0, 4: 6, 8: 4, 16: 0}
    assert _read("units_computed_pct", ctx) == 15.0
    assert _read("bucket_fill_pct", ctx) == 100.0 * 24 / (4 * 6 + 8 * 4)
    for name in ("idle_pct.tput", "chunk_busy_ms.rate",
                 "sliding_assoc_roofline_pct", "seg_dirty_roofline_pct"):
        assert _read(name, ctx) is None
    ctx.trace = {"window_s": 0.5, "busy_s": 0.4,
                 "kernels": {"sliding_long_kernel": [0.001, 4],
                             "seg_dirty_kernel": [0.002, 2]}, "idle": {}}
    assert abs(_read("idle_pct.tput", ctx) - 20.0) < 1e-9
    shapes = harness.ShapeLog()
    shapes.per_units = {4: [("sliding_assoc", (8, 10, 3, "add"), 640)],
                        8: [("sliding_assoc", (16, 10, 3, "add"), 1280)]}
    shapes.outside = {("seg_dirty", ("rows", 1)): 3350}
    ctx.shapes, ctx.trace_chunks, ctx.trace_picks = shapes, 2, {4: 1, 8: 1}
    assert abs(_read("sliding_assoc_roofline_pct", ctx)
               - 100 * (1920 / 3.35e12) / 0.001) < 1e-12
    assert abs(_read("seg_dirty_roofline_pct", ctx)
               - 100 * (2 * 3350 / 3.35e12) / 0.002) < 1e-12
    op = _ctx(loop="open")
    op.trace, op.trace_chunks = ctx.trace, 8
    assert abs(_read("chunk_busy_ms.rate", op) - 50.0) < 1e-9


def test_keep_draws_from_the_seed_and_keeps_the_last():
    def drawn(seed):
        k = harness.Keep(4, seed)
        for c in range(100, 200):
            k.offer(c, c)
        return [c for c, _ in k.chunks()]
    a = drawn(7)
    assert a == drawn(7) and a != drawn(8)
    assert len(a) == 5 and a[-1] == 199
