"""Readings of the runner's own spans and chunk events over a recorded
stretch of a cell: where a step's host time goes, what each chunk takes
on the card, the idle gaps between chunks, and where set-up goes.

:func:`recorded_stretch` runs the cell's loop with the runner's recorder
on and no profiler; the readers take what it returns:
``step_launch_ms`` (host ms a chunk in ``runner.step/launch``),
``step_eager_ms`` (host ms a chunk in ``runner.step`` outside
``launch``), ``chunk_device_ms`` (mean device ms a chunk between its two
chunk events), ``chunk_gap_pct`` (share of the recorded stretch, first
chunk's start to last chunk's end, in gaps between chunks); and
``capture_s`` (seconds in ``runner.capture`` spans during set-up) the
tracer's ``span_report()``.  Each reads the program's spans or events,
and is ``None`` where the run gave it nothing to read: no chunk events
(the CPU), a dropped event, no capture, or a program without the
recorder.  :func:`gap_labels` ranks the gaps by what the host was doing;
:func:`anchor_error_us` measures the recorder's anchor on the card.
No benchmark run calls these yet.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class Recorded:
    """One recorded stretch: the tracer's events, chunk intervals and
    gaps, and the benchmark's own clock around ``Runner.step``."""
    chunks: int                  # steps in the stretch
    seconds: float               # first dispatch to the closing sync
    step_host_s: float           # the benchmark's clock around each step
    events: list
    device: list                 # the tracer's DeviceChunk intervals
    gaps: list
    dropped: int


def recorded_stretch(ses, seconds: float, rate: float) -> Optional[Recorded]:
    """Run the cell's loop for ``seconds`` on the session ``ses`` with the
    runner's recorder on, its buffer sized for twice ``rate`` chunks a
    second; ``None`` where the program has no recorder."""
    tr = ses.runner.metrics.tracer
    if not hasattr(tr, "start_recording"):
        return None
    from repro_torch.obs.trace import SPANS_A_CHUNK
    # what the caller dropped before (a profile's objects, say) is
    # collected now: a full collection inside the stretch, which starts on
    # an empty queue, stalled the H100's host 250-320 ms while the card
    # waited inside a chunk
    gc.collect()
    capacity = SPANS_A_CHUNK * (int(rate * seconds * 2) + 64)
    tr.start_recording(capacity, device=ses.dev)
    try:
        loop = ses.window(seconds)
    finally:
        tr.stop_recording()
    return Recorded(chunks=loop.chunks, seconds=loop.window_s,
                    step_host_s=loop.step_host_s, events=tr.events(),
                    device=tr.device_chunks(), gaps=tr.idle_gaps(),
                    dropped=tr.dropped)


def _sum_ns(rec: Recorded, path: str) -> int:
    return sum(e.end_ns - e.start_ns for e in rec.events
               if e.path == path and e.end_ns)


def _steps(rec: Optional[Recorded]) -> int:
    """The recorded stretch's complete steps, 0 where there is nothing to
    read from its spans."""
    if rec is None or rec.dropped:
        return 0
    return sum(1 for e in rec.events if e.path == "runner.step"
               and e.end_ns)


def step_launch_ms(rec: Optional[Recorded]) -> Optional[float]:
    """Host ms a chunk in ``runner.step/launch``."""
    n = _steps(rec)
    return _sum_ns(rec, "runner.step/launch") / n / 1e6 if n else None


def step_eager_ms(rec: Optional[Recorded]) -> Optional[float]:
    """Host ms a chunk in ``runner.step`` outside ``launch`` (ingest, load,
    copy_out, grids)."""
    n = _steps(rec)
    if not n:
        return None
    return (_sum_ns(rec, "runner.step")
            - _sum_ns(rec, "runner.step/launch")) / n / 1e6


def chunk_device_ms(rec: Optional[Recorded]) -> Optional[float]:
    """Mean device ms a chunk between its two chunk events."""
    if rec is None or rec.dropped or not rec.device:
        return None
    return sum(c.end_ns - c.start_ns for c in rec.device) / len(
        rec.device) / 1e6


def chunk_gap_pct(rec: Optional[Recorded]) -> Optional[float]:
    """Share of the recorded stretch, first chunk's start to last chunk's
    end, in gaps between chunks."""
    if rec is None or rec.dropped or len(rec.device) < 2:
        return None
    whole = rec.device[-1].end_ns - rec.device[0].start_ns
    return 100.0 * sum(g.end_ns - g.start_ns for g in rec.gaps) / whole


def capture_s(spans: Dict[str, dict]) -> Optional[float]:
    """Seconds in ``runner.capture`` spans (``spans``: the tracer's
    ``span_report()`` at the end of set-up), at any depth."""
    caps = [s["total_s"] for p, s in spans.items()
            if p.split("/")[-1] == "runner.capture"]
    return sum(caps) if caps else None


def gap_labels(rec: Recorded, n: int = 10) -> List[list]:
    """The ``n`` labels with the most gap time, ``[label, seconds,
    gaps]``, largest first."""
    by: Dict[str, list] = {}
    for g in rec.gaps:
        s = by.setdefault(g.label, [0.0, 0])
        s[0] += (g.end_ns - g.start_ns) / 1e9
        s[1] += 1
    return [[k, v[0], v[1]] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1][0])[:n]]


def anchor_error_us(tracer, device, n: int = 100) -> Dict[str, float]:
    """The recorder's anchor alignment: ``n`` times, after a synchronize,
    an event recorded on the idle card, its device stamp on the host clock
    (:meth:`Tracer.on_host_clock`) less the host's clock read just before
    the record, in microseconds."""
    import torch
    errs = []
    for _ in range(n):
        torch.cuda.synchronize(device)
        e = torch.cuda.Event(enable_timing=True)
        h = time.perf_counter_ns()
        e.record()
        e.synchronize()
        errs.append((tracer.on_host_clock(e) - h) / 1e3)
    q = statistics.quantiles(errs, n=4)
    return {"median": statistics.median(errs), "q1": q[0], "q3": q[2],
            "min": min(errs), "max": max(errs), "n": n}
