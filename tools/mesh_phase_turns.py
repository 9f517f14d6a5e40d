#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` (mesh placement on a 1-rank NCCL mesh)
four times in one process, on a card: A B B A, where A records the
kernels' shapes as ``chip_smoke.py`` does and B does not.

    python3 tools/mesh_phase_turns.py [OUT.json]

Each run makes its mesh anew (the one before destroyed its group) and
checks everything the phase checks.  The host-paced cells of the phase
spread widely from one call to the next; this compares the two ways of
running it within one call and says how far a cell moves between runs
of the same kind.  Writes every run's per-cell ms (mesh and local) and
seconds to ``OUT.json`` (default ``chiprun_out/mesh_phase_turns.json``)
and prints one line per cell.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _cells(out: dict) -> dict:
    cells = {}
    for k, v in out["one_shot"].items():
        cells[f"shard_map_run {k}"] = (v["ms"], v["local_ms"])
    cells["shard_union_run"] = (out["union"]["ms"], out["union"]["local_ms"])
    for k, v in out["runner"].items():
        cells[f"runner {k}"] = (v["ms_per_chunk"], v["local_ms_per_chunk"])
    for k in ("keyed_engine", "keyed_session"):
        cells[k] = (out[k]["ms_per_chunk"], out[k]["local_ms_per_chunk"])
    return cells


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_phase_turns: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.build import library
    library.load()
    dev = torch.device("cuda")
    errs = {"prefix_scan": 0.0, "sliding_assoc": 0.0}
    recording = cs.recording
    runs = []
    for tag in ("record", "plain", "plain", "record"):
        cs.recording = (recording if tag == "record"
                        else (lambda seen, fn: fn))
        t0 = time.perf_counter()
        out = cs.run_mesh(dev, {}, errs)
        runs.append({"tag": tag, "seconds": time.perf_counter() - t0,
                     "cells": _cells(out)})
    cs.recording = recording
    path = Path(sys.argv[1] if len(sys.argv) > 1
                else ROOT / "chiprun_out" / "mesh_phase_turns.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"card": cs.card_line(), "runs": runs},
                               indent=1))
    print(cs.card_line())
    print("runs: " + ", ".join(f"{r['tag']} {r['seconds']:.1f} s"
                               for r in runs))
    for cell in runs[0]["cells"]:
        print(f"{cell}: mesh - local ms " + " / ".join(
            f"{r['tag']} {r['cells'][cell][0] - r['cells'][cell][1]:+.3f}"
            for r in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
