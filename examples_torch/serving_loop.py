"""Low-latency serving demo on the PyTorch port: the fraud app behind
`repro_torch.serve`.

A credit-card anomaly query (trailing-window mean+3σ threshold, the
paper's fraud app at demo scale) served two ways:

* **chunk path** — `build_service` wires the persisted plan and capture
  caches and returns a warmed `ServeLoop` (on the card every step it runs
  is captured as a CUDA graph ahead of the first request); the generator
  double-buffers (chunk k+1's pinned copy to the card, on a side stream,
  overlaps chunk k's compute) and the steady-state tail runs under
  `torch.cuda.set_sync_debug_mode("error")`: any synchronizing call
  raises, so every copy to the card is the loop's own asynchronous one.
* **event path** — per-transaction events go through a fixed-capacity
  FIFO admission ring (backpressure by shed policy, `serve.*` telemetry)
  into the disorder-tolerant `IngestRunner`; chunks seal as the
  watermark passes and admission→result latency is observed per seal.

Run it twice to see the persisted warm start: the first run plans and
persists the plan artifact and capture manifests under
``out/serving_demo_torch/``; the second rebuilds the runner from the plan
artifact (no planning, no evaluation of the body to size its seeds) and
prints ``plan=warm``.  CUDA graphs are captured anew in every process.

Run:  PYTHONPATH=src python examples_torch/serving_loop.py [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
On the CPU there is nothing to capture or synchronize, so the steady tail
runs without the sync guard.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core.frontend import TStream
from repro_torch.core.stream import Event, SnapshotGrid
from repro_torch.serve import build_service

SEG = 64          # output ticks per segment
SPC = 4           # segments per chunk
CHUNK = SEG * SPC
N_CHUNKS = 8
CACHE = "out/serving_demo_torch"


def fraud_query(win: int = 64):
    s = TStream.source("in", prec=1)
    mu = s.window(win).mean().shift(1)
    sd = s.window(win).stddev().shift(1)
    thr = mu.join(sd, lambda m, d: m + 3.0 * d)
    return s.join(thr, lambda x, t: x - t).where(lambda e: e > 0)


def amounts(rng, n):
    amt = rng.lognormal(3.0, 1.0, n).astype(np.float32)
    amt[rng.random(n) < 0.002] *= 50.0  # injected fraud
    return amt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)
    where = D.name(dev)

    t0 = time.perf_counter()
    svc = build_service(fraud_query(), out_len=SEG, segs_per_chunk=SPC,
                        cache_dir=CACHE, device=dev)
    print(f"build_service: plan={svc.plan_source} "
          f"aot={svc.aot_report} "
          f"({time.perf_counter() - t0:.2f}s on {where})")

    # -- chunk path: double-buffered generator ------------------------------
    rng = np.random.default_rng(0)

    def requests():
        for i in range(N_CHUNKS):
            # host numpy on purpose: the loop's pinned, asynchronous copy
            # is the only transfer to the card on the steady-state path
            yield {"in": SnapshotGrid(value=amounts(rng, CHUNK),
                                      valid=np.ones(CHUNK, bool),
                                      t0=i * CHUNK, prec=1)}

    gen = svc.serve(requests())
    outs = [next(gen)]
    flagged = int(outs[0].valid.sum())
    first = time.perf_counter() - t0
    outs.append(next(gen))
    flagged += int(outs[1].valid.sum())
    # steady state: on the card a synchronizing call raises; the CPU has
    # nothing to synchronize, so it runs without the guard
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        tail = list(gen)
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    outs += tail
    flagged += int(sum(int(o.valid.sum()) for o in tail))
    snap = svc.runner.metrics.snapshot()
    lat = snap["histograms"]["serve.call_seconds"]
    captures = svc.runner.metrics.tracer.captures()
    print(f"chunk path: {N_CHUNKS} chunks, {flagged} flagged ticks, "
          f"first result {first:.2f}s, p50 {lat['p50'] * 1e3:.2f}ms "
          f"p99 {lat['p99'] * 1e3:.2f}ms on {where}, "
          f"captures={captures or '{}'}")

    # -- event path: admission ring -> watermark-sealed chunks --------------
    svc2 = build_service(fraud_query(), out_len=SEG, segs_per_chunk=SPC,
                         cache_dir=CACHE, device=dev)
    svc2.attach_events(lateness=32, policy="drop", capacity=4096,
                       shed="newest")
    sealed_all = []
    for t, a in enumerate(amounts(rng, 2 * CHUNK)):
        svc2.offer("in", Event(t, t + 1, float(a)))
        if (t + 1) % 256 == 0:
            sealed, _ = svc2.pump()
            sealed_all += sealed
    sealed, _ = svc2.finish()
    sealed_all += sealed
    snap2 = svc2.runner.metrics.snapshot()
    a2r = snap2["histograms"]["serve.admit_to_result_seconds"]
    admitted = int(snap2["counters"]["serve.admitted"]["value"])
    shed = int(snap2["counters"]["serve.shed_events"]["value"])
    print(f"event path: {admitted} events admitted, {len(sealed_all)} "
          f"chunks sealed, admit→result p50 {a2r['p50'] * 1e3:.1f}ms on "
          f"{where} (shed={shed})")
    return {"plan_source": svc.plan_source, "aot": svc.aot_report,
            "captures": captures, "flagged": flagged, "first_s": first,
            "p50_s": lat["p50"], "p99_s": lat["p99"], "outs": outs,
            "event_plan_source": svc2.plan_source, "admitted": admitted,
            "sealed_chunks": len(sealed_all), "shed": shed,
            "admit_to_result_p50_s": a2r["p50"],
            "sealed": [s.outputs for s in sealed_all]}


if __name__ == "__main__":
    main()
