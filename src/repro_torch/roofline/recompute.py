"""Re-derive roofline terms from saved dry-run traces (port of
``repro.roofline.recompute``).

The reference replays its HLO parser over saved ``out/hlo/*.hlo``; the
port has no HLO and replays the roofline over the collective records and
costs each cell saved with ``--trace-dir`` (the cell JSON's own ``coll``
and ``cost`` where no trace file is there), so a change of the ring
factors or the hardware constants needs no new trace.

Usage: PYTHONPATH=src python -m repro_torch.roofline.recompute \\
    out/dryrun out/dryrun_trace
"""
from __future__ import annotations

import glob
import json
import os
import sys

from .analysis import roofline

__all__ = ["main"]


def main(out_dir: str = "out/dryrun", trace_dir: str = "out/dryrun_trace"):
    for jpath in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(jpath) as f:
            d = json.load(f)
        if not d.get("ok") or "roofline" not in d:
            continue
        tpath = os.path.join(
            trace_dir, f"{d['arch']}_{d['shape']}_{d['mesh']}.json")
        cost, coll = d["cost"], d["coll"]
        if os.path.exists(tpath):
            with open(tpath) as f:
                saved = json.load(f)
            cost, coll = saved["cost"], saved["collectives"]
        rep = roofline(cost, coll, d["roofline"]["model_flops"])
        d["roofline"] = rep.to_dict()
        with open(jpath, "w") as f:
            json.dump(d, f, indent=1)
        print(f"recomputed {os.path.basename(jpath)}: "
              f"dom={rep.dominant} rf={rep.roofline_fraction:.4f}")


if __name__ == "__main__":
    main(*sys.argv[1:])
