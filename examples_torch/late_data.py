"""Out-of-order ingestion demo on the PyTorch port: a fraud stream with 5%
shuffled-late events through the disorder-tolerant IngestRunner front end.

A credit-card anomaly query (trailing-window mean+3σ threshold, the
paper's fraud app shrunk to demo scale) consumes one transaction event
per tick — except 5% of them arrive up to two chunks late, well past the
watermark's lateness allowance.  The pipeline:

* rasterizes arrivals through a bounded reorder buffer (in-allowance
  disorder is invisible),
* seals + executes chunks as the per-key watermark passes them,
* patches sealed rasters with late events and re-runs ONLY the
  ChangePlan-dilated output segments (sparse revisions), emitting
  versioned corrections.

The demo ends by overlaying the corrections onto the sealed outputs and
asserting bit-identity with an in-order run — the disorder-insensitivity
invariant tests/test_torch_ingest.py holds.

Run:  PYTHONPATH=src python examples_torch/late_data.py [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
"""
import argparse

import numpy as np

from repro_torch import device as D
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.core.stream import Event, EventStream, events_to_grid
from repro_torch.engine import ExecPolicy, Runner
from repro_torch.ingest import IngestRunner

SEG = 64          # output ticks per segment
SPC = 4           # segments per chunk
CHUNK = SEG * SPC
N_CHUNKS = 8
N = CHUNK * N_CHUNKS
LATE_FRAC = 0.05
LATENESS = 32     # watermark allowance (time units)


def fraud_query(win: int = 64):
    s = TStream.source("in", prec=1)
    mu = s.window(win).mean().shift(1)
    sd = s.window(win).stddev().shift(1)
    thr = mu.join(sd, lambda m, d: m + 3.0 * d)
    return s.join(thr, lambda x, t: x - t).where(lambda e: e > 0)


def make_events(rng) -> list:
    amt = rng.lognormal(3.0, 1.0, N)
    amt[rng.random(N) < 0.002] *= 50.0  # injected fraud
    return [Event(t, t + 1, float(a)) for t, a in enumerate(amt)]


def shuffled(events, rng) -> list:
    """5% of events displaced by up to two chunks; the rest in order."""
    n = len(events)
    late = rng.random(n) < LATE_FRAC
    disp = np.where(late, rng.integers(LATENESS + 1, 2 * CHUNK, size=n), 0)
    order = np.argsort(np.arange(n) + disp, kind="stable")
    return [events[i] for i in order]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)

    rng = np.random.default_rng(7)
    events = make_events(rng)
    exe = qc.compile_query(fraud_query().node, out_len=SEG, sparse=True)

    # in-order reference
    ref = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC).run(
        {"in": events_to_grid(EventStream(events), 0, N, 1, device=dev)},
        N_CHUNKS)

    # disorder-tolerant pipeline over the shuffled arrival order
    runner = Runner(exe, ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    ing = IngestRunner(runner, lateness=LATENESS, policy="revise",
                       horizon_chunks=3, device=dev)
    sealed, corrections = [], []
    for ev in shuffled(events, rng):
        ing.push("in", ev)
        s, c = ing.poll()
        sealed += s
        corrections += c
    s, c = ing.flush()
    sealed += s
    corrections += c

    snap = runner.metrics.snapshot()["counters"]
    figures = {"events": len(events), "sealed_chunks": len(sealed),
               "late": snap["ingest.late_events"]["value"],
               "revised": snap["ingest.revised_events"]["value"],
               "corrections": len(corrections),
               "revision_units": snap["runner.revision_units"]["value"],
               "revision_chunks": snap["runner.revision_chunks"]["value"]}
    print(f"events={figures['events']}  "
          f"sealed_chunks={figures['sealed_chunks']}  "
          f"late={figures['late']}  revised={figures['revised']}  "
          f"corrections={figures['corrections']}  (device {D.name(dev)})")
    print(f"revision work: {figures['revision_units']} dirty "
          f"segments recomputed across {figures['revision_chunks']} chunk "
          f"revisions (a dense replay would be "
          f"{figures['revision_chunks'] * SPC})")

    # overlay corrections (version order) and check bit-identity
    final = {sc.chunk: (sc.outputs.value.cpu().numpy(),
                        sc.outputs.valid.cpu().numpy()) for sc in sealed}
    for co in sorted(corrections, key=lambda c: (c.chunk, c.version)):
        v, m = final[co.chunk]
        tick = np.repeat(np.asarray(co.seg_mask), SEG)
        final[co.chunk] = (np.where(tick, co.outputs.value.cpu().numpy(), v),
                           np.where(tick, co.outputs.valid.cpu().numpy(), m))
    refv, refm = ref.value.cpu().numpy(), ref.valid.cpu().numpy()
    flagged = 0
    for c in range(N_CHUNKS):
        v, m = final[c]
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        assert np.array_equal(m, refm[sl])
        assert np.array_equal(v[m], refv[sl][m])
        flagged += int(m.sum())
    print(f"disorder-insensitivity OK: sealed+corrections bit-identical "
          f"to in-order ({flagged} fraud flags)")
    return {**figures, "flagged": flagged,
            "value": np.concatenate([final[c][0] for c in range(N_CHUNKS)]),
            "valid": np.concatenate([final[c][1] for c in range(N_CHUNKS)])}


if __name__ == "__main__":
    main()
