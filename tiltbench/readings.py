#!/usr/bin/env python3
"""The readings the comparison's limits are set from, on the card.

    python3 tiltbench/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control]

For each seed, in one process (the program is built once, and each seed
starts a fresh stream on the same steps): the cell's own loop for
``--seconds``, the sampled chunks held against the reference, and the
worst of each number (the program's reading).  With ``--control`` the
same chunks are answered by the reference itself computed in bfloat16,
the precision below the configuration's float32, and held the same way
(the control's reading).  One JSON line a seed.  The benchmark's own runs
never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from tiltbench import harness
    if a.device == "cuda":
        from repro_torch.kernels.build import library
        library.load()
    cell = harness.load_cell(a.workload, False)
    ses = harness.Session(cell, a.device)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        ses.load(seed)
        keep = harness.Keep(cell.compare_chunks, seed)
        loop = ses.window(a.seconds, keep)
        kept = keep.chunks()
        prog, failed = ses.compare(kept)
        line = {"workload": a.workload, "seed": seed, "chunks": loop.chunks,
                "compared": [c for c, _ in kept], "program": prog,
                "failed": failed}
        if a.control:
            ctl, cfailed = ses.compare(kept, outputs=lambda ref, prev, cur, pr:
                                       ref.evaluate(prev, cur, pr,
                                                    torch.bfloat16))
            line["control"], line["control_failed"] = ctl, cfailed
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
