"""Runtime telemetry walkthrough on the PyTorch port: watch the sparse
engine observe itself.

Drives a keyed fraud-style query through the chunked Runner with a
mostly-idle key population, then reads everything the engine recorded
about its own execution — without ever reading the card on the hot path:

* compaction counters and the capacity-bucket pick distribution (which
  rung of the capacity ladder each chunk's dirty count landed on);
* the plan's gauges of a unit's window: the share of the contract the
  body leaves out (``runner.eval_trim_pct``) and the share of what it
  evaluates that is lookback, evaluated again in every unit
  (``runner.halo_eval_pct``);
* the per-chunk latency histogram with p50/p90/p99;
* the recompile detector (every staging key must be built exactly once)
  and the CUDA graphs the runner captured (none on the CPU);
* the tracer's recorder: each chunk's ``runner.step`` split into its
  parts by self time, and on the card each chunk's device interval and
  the idle gaps between chunks, labelled by what the host was doing;
* the JSONL + Prometheus exporters fed by the same snapshot.

The runner writes its carried state in place in every step; where the
reference counts buffer-donating steps, this prints the captured graphs.

Run:  PYTHONPATH=src python examples_torch/metrics_observability.py
      [n_chunks] [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
The metrics land in ``out/metrics.jsonl`` under the working directory.
"""
import argparse
import os

import numpy as np

from repro_torch import device as D
from repro_torch import obs
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.engine import ExecPolicy, Runner, keyed_grid

K = 64          # keyed sub-streams, ~1 in 16 active
SEG = 128
SPC = 4
SPAN = SEG * SPC
OUT = "out/metrics.jsonl"


def make_chunks(n_chunks: int, dev):
    rng = np.random.default_rng(0)
    T = n_chunks * SPAN
    vals = np.broadcast_to(rng.integers(0, 100, (K, 1)).astype(np.float32),
                           (K, T)).copy()
    for k in range(0, K, 16):                      # the active keys
        vals[k] = np.floor(rng.random(T) * 100)
    return [{"in": keyed_grid(vals[:, c * SPAN:(c + 1) * SPAN],
                              np.ones((K, SPAN), bool), t0=c * SPAN,
                              device=dev)}
            for c in range(n_chunks)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_chunks", nargs="?", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)

    s = TStream.source("in", prec=1, keyed=True)
    q = (s.window(32).mean().shift(1)
         .join(s, lambda m, x: x - m)
         .where(lambda d: d > 0))
    exe = qc.compile_query(q.node, out_len=SEG, sparse=True)
    r = Runner(exe, ExecPolicy(body="sparse", keys="vmapped"), n_keys=K,
               segs_per_chunk=SPC)

    # the recorder: every span of a step becomes one event (and, on the
    # card, each chunk two timing events); off, a step records nothing
    tracer = r.metrics.tracer
    tracer.start_recording(1024, device=dev)
    outs = []
    for chunk in make_chunks(args.n_chunks, dev):
        outs.append(r.step(chunk))
        D.synchronize(dev)
    tracer.stop_recording()

    # the single device→host read; everything above accumulated on the card
    snap = r.metrics.snapshot()
    problems = obs.validate_snapshot(snap)
    assert problems == [], problems

    c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
    captures = r.metrics.tracer.captures()
    print(f"chunks={c['runner.chunks']['value']}  "
          f"work units={c['runner.units']['value']}  "
          f"dirty={c['runner.dirty_units']['value']}  "
          f"compact={g['runner.compact']['value']:.3f}  "
          f"captured graphs={sum(captures.values())}")

    print(f"unit window: eval_trim_pct="
          f"{g['runner.eval_trim_pct.in']['value']:.2f}%  halo_eval_pct="
          f"{g['runner.halo_eval_pct.in']['value']:.2f}%")

    picks = snap["vectors"]["runner.bucket_picks"]
    used = {lab: n for lab, n in zip(picks["labels"], picks["values"]) if n}
    print("capacity-bucket picks:", used)

    lat = h["runner.step_seconds"]
    print(f"chunk latency on {D.name(dev)}: p50={lat['p50'] * 1e6:.0f}us  "
          f"p90={lat['p90'] * 1e6:.0f}us  p99={lat['p99'] * 1e6:.0f}us  "
          f"(n={lat['count']}; the tail is the first chunks, which build "
          "and capture the steps — benchmarks run a fresh runner on built "
          "steps to scope the histogram to steady state)")

    n = args.n_chunks
    own = tracer.self_times()
    print("step parts, self time a chunk (the first chunks build and "
          "capture their steps inside launch):")
    for path in (p for p in own if p.startswith("runner.step")):
        print(f"  {path:<22} {own[path] / n / 1e3:9.1f}us")
    spans = {p: s["count"] for p, s in tracer.span_report().items()
             if p.endswith("runner.capture")}
    print(f"capture spans: {spans}  dropped events: {tracer.dropped}")
    chunks, gaps = tracer.device_chunks(), tracer.idle_gaps()
    if chunks:
        busy = sum(c.end_ns - c.start_ns for c in chunks) / len(chunks)
        print(f"device ms a chunk: {busy / 1e6:.3f}; idle gaps by label: "
              f"{sorted({g.label for g in gaps})}")

    comp = r.metrics.tracer.compile_report()
    print(f"staged builds: {comp['counts']}")
    print(f"retraces (must be empty): {comp['retraces']}")

    # exporters consume snapshots, never live metrics
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    obs.export_jsonl(snap, OUT)
    prom = obs.export_prometheus(snap)
    print(f"\nwrote {OUT}; prometheus exposition "
          f"({len(prom.splitlines())} lines), sample:")
    for line in prom.splitlines():
        if line.startswith(("runner_compact", "runner_chunks_total",
                            "runner_step_seconds_count")):
            print(" ", line)
    return {"snapshot": snap, "bucket_picks": used, "compiles": comp,
            "self_times": own, "device_chunks": chunks, "idle_gaps": gaps,
            "captures": captures, "prometheus_lines": len(prom.splitlines()),
            "outs": outs}


if __name__ == "__main__":
    main()
