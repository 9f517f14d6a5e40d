#!/usr/bin/env python3
"""Benchmark of the PyTorch and CUDA port of TiLT (``repro_torch``) on one
NVIDIA card: keyed streaming queries on the chunked runner.

    python3 tiltbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout.  The cells, their configurations,
traffic and metrics are named in ``BENCHMARK.json``; see
``tiltbench/harness.py``.  The last line on standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last); the last
lines on standard error are the numbers compared with the plain
reference, each beside its limit.  The run exits non-zero and prints no
result where no CUDA card (or too few) is there, where the port is not
beside the benchmark, or where ``jax``, ``jaxlib``, ``flax`` or ``repro``
was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _die(code: int, msg: str) -> int:
    print(msg, file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _die(4, f"the port (src/repro_torch) is not in {ROOT}")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from tiltbench import harness
    cell = harness.load_cell(a.workload, bool(a.trace))
    if not torch.cuda.is_available():
        return _die(2, "no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < cell.chips:
        return _die(2, f"the cell needs {cell.chips} cards, "
                       f"{torch.cuda.device_count()} are there")
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           T_START)
    bad = harness.forbidden_modules()
    if bad:
        return _die(3, f"modules loaded that the benchmark may not load: "
                       f"{bad}")
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
