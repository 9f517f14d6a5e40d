"""End-to-end streaming analytics: the applications of
``data/apps.py`` (paper Table 2's nine, and Pan-Tompkins QRS detection with
the published filters) running continuously over unbounded
synthetic streams with the checkpointable ``StreamRunner`` of the PyTorch
port.

``StreamRunner`` is the deprecated alias of ``engine.Runner(exe,
ExecPolicy())`` and warns so.  The runner runs lookback-only queries; the
lookahead ones (znorm, impute, resample) run partitioned instead.

Run:  PYTHONPATH=src python examples_torch/stream_analytics.py [n_chunks]
      [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
"""
import argparse
import time

from repro_torch import device as D
from repro_torch.core import compile as qc
from repro_torch.core.parallel import StreamRunner, partition_run
from repro_torch.data import apps as A

CHUNK = 100_000


def run_app(name: str, n_chunks: int, dev) -> dict:
    app = A.make_app(name)
    exe = qc.compile_query(app.query.node, out_len=CHUNK // app.query.prec)
    try:
        runner = StreamRunner(exe)
    except NotImplementedError:
        # lookahead queries (znorm/impute/resample) run partitioned instead
        grids = A.make_grids(app.make_input(CHUNK * n_chunks, 1),
                             device=dev)
        D.synchronize(dev)
        t0 = time.perf_counter()
        out = partition_run(exe, grids, 0, n_chunks)
        D.synchronize(dev)
        dt = time.perf_counter() - t0
        n = CHUNK * n_chunks
        total_out = int(out.valid.sum())
        print(f"{name:12s} {n/dt/1e6:7.2f}M ev/s on {D.name(dev)}  "
              f"{total_out:8d} output events (partitioned; lookahead "
              f"query)")
        return {"mode": "partitioned", "events_per_s": n / dt,
                "output_events": total_out, "outputs": [out]}

    D.synchronize(dev)
    t0 = time.perf_counter()
    total_out = 0
    outs = []
    for k in range(n_chunks):
        chunks = A.make_grids(app.make_input(CHUNK, seed=k), device=dev)
        out = runner.step(chunks)
        outs.append(out)
        total_out += int(out.valid.sum())
    D.synchronize(dev)
    dt = time.perf_counter() - t0
    n = CHUNK * n_chunks
    tails = len(runner.state()) - 1
    print(f"{name:12s} {n/dt/1e6:7.2f}M ev/s on {D.name(dev)}  "
          f"{total_out:8d} output events (continuous, state={tails} tails)")
    return {"mode": "continuous", "events_per_s": n / dt,
            "output_events": total_out, "tails": tails, "outputs": outs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_chunks", nargs="?", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)
    return {name: run_app(name, args.n_chunks, dev) for name in A.APPS}


if __name__ == "__main__":
    main()
