"""``tiltbench/spans.py``: its readings' arithmetic on hand-made records,
a small run on the CPU (the span readings, none of the device ones) and
the test data's sparse fraud cell on the card (all five)."""
import time
import types

import pytest

from conftest import CELLS
from repro_torch.obs import DeviceChunk, Event, Gap
from tiltbench import harness, spans


def _chunk(c, t0, parts):
    """The events of one recorded step starting at ``t0`` (event index
    ``c * 6``), its parts lasting ``parts`` ns each, back to back."""
    base = c * 6
    out = [Event("runner.step", t0, t0 + sum(parts) + 2, -1, c + 1)]
    t = t0 + 1
    for name, d in zip(["ingest", "load", "launch", "copy_out", "grids"],
                       parts):
        out.append(Event(f"runner.step/{name}", t, t + d, base, c + 1))
        t += d
    return out


def _rec(dropped=0, device=None, gaps=None):
    events = (_chunk(0, 0, [10, 20, 1000, 30, 5])
              + _chunk(1, 2000, [10, 20, 3000, 30, 5]))
    return spans.Recorded(chunks=2, seconds=1.0, step_host_s=0.0,
                          events=events, device=device or [],
                          gaps=gaps or [], dropped=dropped)


def test_readings_of_a_hand_made_record():
    device = [DeviceChunk(1, 0, 1_000_000), DeviceChunk(2, 1_100_000,
                                                        2_000_000),
              DeviceChunk(3, 2_000_000, 3_000_000)]
    gaps = [Gap(1_000_000, 1_100_000, "runner.step/load"),
            Gap(2_000_000, 2_000_000, "outside the program")]
    rec = _rec(device=device, gaps=gaps)
    # launch: (1000 + 3000) ns over two steps
    assert spans.step_launch_ms(rec) == pytest.approx(2000 / 1e6)
    # each step is its parts plus 2 ns; outside launch 65 + 2 a step
    assert spans.step_eager_ms(rec) == pytest.approx(67 / 1e6)
    assert spans.chunk_device_ms(rec) == pytest.approx(
        (1.0 + 0.9 + 1.0) / 3)
    assert spans.chunk_gap_pct(rec) == pytest.approx(100 * 0.1 / 3.0)
    assert spans.gap_labels(rec) == [["runner.step/load", 1e-4, 1],
                                     ["outside the program", 0.0, 1]]
    assert spans.capture_s({"runner.install/runner.capture":
                            {"total_s": 0.25},
                            "runner.capture": {"total_s": 0.5},
                            "runner.capture/record": {"total_s": 0.4}}
                           ) == pytest.approx(0.75)


def test_readings_read_nothing_where_the_run_gave_nothing():
    cpu = _rec()
    assert spans.chunk_device_ms(cpu) is None
    assert spans.chunk_gap_pct(cpu) is None
    dropped = _rec(dropped=1, device=[DeviceChunk(1, 0, 5),
                                      DeviceChunk(2, 6, 9)])
    for read in (spans.step_launch_ms, spans.step_eager_ms,
                 spans.chunk_device_ms, spans.chunk_gap_pct):
        assert read(dropped) is None and read(None) is None
    assert spans.capture_s({"runner.install": {"total_s": 1.0}}) is None
    # a program without the recorder gives no recorded stretch
    old = types.SimpleNamespace(
        runner=types.SimpleNamespace(metrics=types.SimpleNamespace(
            tracer=object())))
    assert spans.recorded_stretch(old, 1.0, 100.0) is None


def _recorded_run(cell_name, seed, device, seconds):
    """The cell built and loaded as the harness does, a window, then a
    recorded stretch of ``seconds`` (the cell's ``trace_seconds``): the
    stretch, the set-up spans, the set-up seconds and the session."""
    kw = dict(CELLS[cell_name])
    kw["overrides"] = dict(kw["overrides"], trace_seconds=seconds)
    cell = harness.load_cell(cell_name, True, **kw)
    t = time.perf_counter()
    ses = harness.Session(cell, device)
    ses.load(seed)
    setup_s = time.perf_counter() - t
    setup = ses.runner.metrics.tracer.span_report()
    window = ses.window(seconds)
    rec = spans.recorded_stretch(ses, cell.trace_seconds,
                                 window.chunks / window.window_s)
    return rec, setup, setup_s, ses


def _host_ms(rec):
    """The benchmark's own clock around ``Runner.step``, ms a chunk."""
    return rec.step_host_s / rec.chunks * 1e3


def test_a_small_run_on_the_cpu_reads_the_spans():
    rec, setup, _, _ = _recorded_run("ysb100", 2**31 + 11, "cpu", 0.3)
    launch, eager = spans.step_launch_ms(rec), spans.step_eager_ms(rec)
    assert launch > 0 and eager > 0
    assert spans.chunk_device_ms(rec) is None
    assert spans.chunk_gap_pct(rec) is None
    assert spans.capture_s(setup) is None    # nothing is captured here
    assert rec.dropped == 0 and rec.chunks >= 1
    # the spans tile the step: the benchmark's own clock around it agrees
    assert launch + eager == pytest.approx(_host_ms(rec), rel=0.05)
    assert setup["runner.install"]["total_s"] > 0


@pytest.mark.cuda
def test_the_sparse_fraud_cell_reads_all_five_on_the_card(cuda):
    from repro_torch.kernels.build import library
    library.load()
    rec, setup, setup_s, ses = _recorded_run("fraud-quiet", 2**31 + 13,
                                             "cuda", 1.0)
    m = {read.__name__: read(rec) for read in (
        spans.step_launch_ms, spans.step_eager_ms, spans.chunk_device_ms,
        spans.chunk_gap_pct)}
    m["capture_s"] = spans.capture_s(setup)
    assert all(v is not None and v >= 0 for v in m.values()), m
    assert rec.dropped == 0 and len(rec.gaps) == rec.chunks - 1
    assert 0 < m["capture_s"] < setup_s
    assert m["step_launch_ms"] + m["step_eager_ms"] == pytest.approx(
        _host_ms(rec), rel=0.05)
    assert m["chunk_gap_pct"] < 100
    # the anchor, a second after it was set: an event on the idle card
    # lands on the host clock within 100 us of the host's read beside it
    err = spans.anchor_error_us(ses.runner.metrics.tracer, ses.dev)
    assert abs(err["median"]) < 100, err
