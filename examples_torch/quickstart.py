"""Quickstart: the paper's stock-trend query (Fig. 2a) on the PyTorch port.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
"""
import argparse

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import boundary, compile as qc, fusion
from repro_torch.core.frontend import TStream
from repro_torch.core.parallel import partition_run
from repro_torch.core.stream import SnapshotGrid, grid_to_events


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)

    # 1. Define the query with the event-centric surface API; it builds
    #    time-centric TiLT IR underneath (paper Fig. 3a).
    stock = TStream.source("stock", prec=1)
    avg10 = stock.window(10).mean()
    avg20 = stock.window(20).mean()
    diff = avg10.join(avg20, lambda a, b: a - b)
    uptrend = diff.where(lambda d: d > 0)

    # 2. Boundary resolution (paper §5.1): the lookback contract that makes
    #    the unbounded stream partitionable.
    contract = boundary.resolve(uptrend.node)
    print("boundary contract:", contract)

    # 3. IR optimization (paper §5.2): CSE + fusion across pipeline-breakers.
    report = fusion.fusion_report(uptrend.node, fusion.optimize(uptrend.node))
    print("fusion:", report)

    # 4. Compile for 1000-tick partitions and run over a synthetic price
    #    stream; the partitions run where the grid's tensors are.
    exe = qc.compile_query(uptrend.node, out_len=1000)
    prices = 100 + np.cumsum(np.random.default_rng(0).normal(0, 0.5, 4000))
    grid = SnapshotGrid(value=torch.as_tensor(prices, dtype=torch.float32,
                                              device=dev),
                        valid=torch.ones(4000, dtype=torch.bool, device=dev),
                        t0=0, prec=1)
    out = partition_run(exe, {"stock": grid}, 0, 4)

    events = grid_to_events(out)
    n_ticks = int(out.valid.sum())
    print(f"{n_ticks} uptrend ticks -> {len(events.events)} merged uptrend "
          f"intervals (device {D.name(dev)})")
    for e in events.events[:5]:
        print(f"  uptrend ({e.start:4d}, {e.end:4d}]  strength "
              f"{e.payload:.3f}")
    return {"device": str(dev), "contract": contract, "fusion": report,
            "uptrend_ticks": n_ticks, "intervals": len(events.events),
            "out": out, "events": events}


if __name__ == "__main__":
    main()
