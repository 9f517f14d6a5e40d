"""Render the dry-run summary and the roofline table (port of
``repro.roofline.report``).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report \\
    [out/dryrun] [PERF.md]

Replaces the ``<!-- DRYRUN_SUMMARY -->`` and ``<!-- ROOFLINE_TABLE -->``
markers of the given markdown file (the reference writes
``EXPERIMENTS.md``, which this repo does not have); the fit limit is one
H100's 80 GB.  Every row names the device type its cell was traced on
("traced on"): only a ``cuda`` trace is the card's program.
"""
from __future__ import annotations

import glob
import json
import os
import sys

from .analysis import HW

__all__ = ["load", "dryrun_summary", "roofline_table", "main"]

HBM = HW().hbm_bytes


def load(out_dir):
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def dryrun_summary(cells):
    ok = [c for c in cells if c.get("ok")]
    fail = [c for c in cells if not c.get("ok")]
    single = [c for c in ok if c["mesh"] == "single"]
    multi = [c for c in ok if c["mesh"] == "multi"]
    fits = [c for c in ok if c.get("per_device_bytes", 0) <= HBM]
    lines = [
        f"Traced OK: **{len(ok)}/{len(cells)}** runs "
        f"({len(single)} single-pod + {len(multi)} multi-pod); "
        f"{len(fits)}/{len(ok)} fit in {HBM / 1e9:.0f} GB per device.",
        "",
        "| arch | shape | mesh | traced on | devices | GB/device | fits "
        "| trace s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in ok:
        gb = c.get("per_device_bytes", 0) / 1e9
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {_on(c)} "
            f"| {c['devices']} | {gb:.2f} | {'✓' if gb * 1e9 <= HBM else '✗'} "
            f"| {c.get('lower_s', 0)} |")
    for c in fail:
        lines.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | {_on(c)} "
                     f"| - | - | FAIL: {c.get('error', '?')[:60]} | - |")
    return "\n".join(lines)


def _on(cell) -> str:
    return cell.get("device_type", "-")


def roofline_table(cells):
    rows = [c for c in cells if c.get("ok") and c.get("roofline")]
    lines = [
        "| arch | shape | traced on | compute s | memory s | collective s "
        "| dominant | useful | roofline frac | one-line next step |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]

    def nextstep(c):
        r = c["roofline"]
        d = r["dominant"]
        if d == "collective":
            kinds = r.get("coll_breakdown", {})
            top = max(kinds, key=kinds.get) if kinds else "?"
            return (f"cut {top} bytes (seq-parallel/RS+AG or wider TP "
                    f"divisibility)")
        if d == "memory":
            if c["shape"].startswith("decode") or c["shape"].startswith(
                    "long"):
                return "quantize KV cache (cache_dtype=f8) / fuse reads"
            return ("fewer materializations: fused attention kernel, "
                    "narrower dtypes")
        return "raise arithmetic intensity per pass (tensor-core tiles)"

    for c in rows:
        r = c["roofline"]
        lines.append(
            f"| {c['arch']} | {c['shape']} | {_on(c)} | {r['compute_s']:.3f} "
            f"| {r['memory_s']:.3f} | {r['collective_s']:.3f} "
            f"| **{r['dominant']}** | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.4f} | {nextstep(c)} |")
    return "\n".join(lines)


def main(out_dir="out/dryrun", target="PERF.md"):
    cells = load(out_dir)
    with open(target) as f:
        text = f.read()
    text = text.replace("<!-- DRYRUN_SUMMARY -->", dryrun_summary(cells))
    text = text.replace("<!-- ROOFLINE_TABLE -->", roofline_table(cells))
    with open(target, "w") as f:
        f.write(text)
    print(f"updated {target} with {len(cells)} cells")


if __name__ == "__main__":
    main(*sys.argv[1:])
