#!/usr/bin/env python3
"""The one-shot entry points and the dashboard session at two commits on
one card, in turns: A B B A, each run in a process of its own.

    python3 tools/one_shot_ab.py ROOT_A ROOT_B [OUT.json]

``ROOT_A`` and ``ROOT_B`` are checkouts of the repo (for example the
parent unpacked under ``out/parent`` with ``git archive``, and ``.``);
each run imports ``repro_torch`` from its root's ``src`` and builds that
root's kernels there.  A run uses only entry points both commits have,
so whether a call is staged or eager is the commit's own default, and
times, in this order (host clock around ``torch.cuda.synchronize``,
after the first use of every shape, the smallest of ``REPS``):

1. the 16-query dashboard session over 2**24 ticks in one chunk (the
   yardstick of ``chip_smoke.py``'s phase 11), fresh;
2. the same session in chunks of 65536 ticks, ms a chunk (phase 8's
   unkeyed cell);
3. every app's ``partition_run`` at 2**24 ticks in partitions of 2**20,
   ms a partition (phase 3);
4. keyed trend, fraud and ysb through ``batch_run`` at 4096 keys x 4096
   ticks, ms a call (phase 4);
5. 1 and 2 again, after 3 and 4 left their state behind;
6. on a 1-rank NCCL mesh, ``shard_union_run`` of the 16 queries and the
   2**24-tick session chunk in turns (session, union, union, session;
   phase 11's cell);
7. then the root's own ``chip_smoke.py`` phase 11 cells for the one-shot
   calls, ``mesh_one_shot`` and ``mesh_union``, as that commit runs them
   (the union's time and its session yardstick, the smaller of two each).

Beside each step: the caching allocator's reserved and allocated GiB.
Writes every run to ``OUT.json`` (default ``chiprun_out/one_shot_ab.json``)
and prints one line per cell with the four runs.
"""
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N_TICKS, PART = 1 << 24, 1 << 20
KEYS, KEY_TICKS = 4096, 4096
MQ_QUERIES, MQ_TICKS, MQ_SPAN = 16, 1 << 24, 65536
REPS = 5


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _best(fn, reps: int = REPS) -> float:
    """ms of the fastest of ``reps`` calls, after one untimed call."""
    fn()
    return min(_timed(fn) for _ in range(reps)) * 1e3


def _memory() -> dict:
    import torch
    return {"reserved_gib": torch.cuda.memory_reserved() / 2**30,
            "allocated_gib": torch.cuda.memory_allocated() / 2**30}


def _session(qs: dict, span: int):
    from repro_torch.multiquery import MultiQuerySession
    sess = MultiQuerySession(span)
    for name, q in qs.items():
        sess.attach(name, q)
    return sess


def one(root: Path, out: Path) -> int:
    """One run, from ``root``: every cell above, written to ``out``."""
    import torch
    from repro_torch.core import compile as qc
    from repro_torch.core.parallel import batch_run, partition_run
    from repro_torch.data import apps as A
    from repro_torch.engine import keyed_grid
    from repro_torch.kernels.build import library
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.multiquery import shard_union_run
    library.load()
    dev = torch.device("cuda")
    cells, memory = {}, {}
    vals = A.dashboard_input(MQ_TICKS, 5)["in"]["value"].astype(np.float32)
    grids = {"in": keyed_grid(vals, np.ones(vals.shape, bool), device=dev)}
    qs = A.dashboard_queries(MQ_QUERIES)

    def sessions(tag: str) -> None:
        whole = _session(qs, MQ_TICKS)
        cells[f"session 2**24 one chunk, {tag}"] = _best(
            lambda: (whole.reset(), whole.run(grids, 1)))
        del whole
        _session(qs, MQ_SPAN).run(grids, 2)      # first use of every shape
        chunks = MQ_TICKS // MQ_SPAN
        cells[f"session 2**24 ms a 65536-tick chunk, {tag}"] = _timed(
            lambda: _session(qs, MQ_SPAN).run(grids, chunks)) * 1e3 / chunks
        memory[f"sessions, {tag}"] = _memory()

    sessions("fresh")
    for name in A.APPS:
        app = A.make_app(name)
        g = A.make_grids(app.make_input(N_TICKS, 0), device=dev)
        exe = qc.compile_query(app.query.node, out_len=PART // app.query.prec)
        n = N_TICKS // PART
        cells[f"partition_run {name}, ms a partition"] = _best(
            lambda: partition_run(exe, g, 0, n), 2) / n
        del g, exe
    memory["after partition_run"] = _memory()
    for name in A.KEYED_APPS:
        app = A.make_keyed_app(name)
        g = A.make_grids(app.make_keyed_input(KEYS, KEY_TICKS, 0), device=dev)
        exe = qc.compile_query(app.query.node,
                               out_len=KEY_TICKS // app.query.prec)
        cells[f"batch_run {name}"] = _best(lambda: batch_run(exe, g))
        if "jit" in inspect.signature(qc.compile_query).parameters:
            eager = qc.compile_query(app.query.node, jit=False,
                                     out_len=KEY_TICKS // app.query.prec)
            cells[f"batch_run {name} jit=False"] = _best(
                lambda: batch_run(eager, g))
            del eager
        del g, exe
    memory["after batch_run"] = _memory()
    sessions("after the one-shot calls")
    mesh = make_local_mesh()
    whole = _session(qs, MQ_TICKS)
    whole.run(grids, 1)
    shard_union_run(qs, MQ_TICKS, grids, mesh)
    turns = {"session": [], "union": []}
    for _ in range(REPS):
        for what in ("session", "union", "union", "session"):
            fn = ((lambda: (whole.reset(), whole.run(grids, 1)))
                  if what == "session"
                  else (lambda: shard_union_run(qs, MQ_TICKS, grids, mesh)))
            turns[what].append(_timed(fn) * 1e3)
    cells["mesh: session 2**24 one chunk"] = min(turns["session"])
    cells["mesh: shard_union_run 16 queries 2**24"] = min(turns["union"])
    memory["mesh"] = _memory()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    cs.mesh_one_shot(dev, mesh, {}, {})
    union = cs.mesh_union(dev, mesh, {}, {})
    cells["chip_smoke mesh_union: session 2**24 one chunk"] = union["local_ms"]
    cells["chip_smoke mesh_union: shard_union_run"] = union["ms"]
    memory["chip_smoke phase 11"] = _memory()
    out.write_text(json.dumps({"root": str(root), "cells": cells,
                               "memory": memory, "turns": turns}, indent=1))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        return one(Path(sys.argv[2]), Path(sys.argv[3]))
    import torch
    if not torch.cuda.is_available():
        print("one_shot_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(sys.argv[1]).resolve(), Path(sys.argv[2]).resolve()]
    path = Path(sys.argv[3] if len(sys.argv) > 3
                else ROOT / "chiprun_out" / "one_shot_ab.json").resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for i, root in enumerate((roots[0], roots[1], roots[1], roots[0])):
        part = path.with_suffix(f".{i}.json")
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--one", str(root), str(part)],
                             cwd=root, env=env, timeout=900)
        if res.returncode:
            print(f"one_shot_ab: the run from {root} exited "
                  f"{res.returncode}", file=sys.stderr)
            return 1
        run = json.loads(part.read_text())
        run["seconds"] = time.perf_counter() - t0
        runs.append(run)
    card = _card_line()
    path.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    print(card)
    print("runs: " + ", ".join(f"{Path(r['root']).name or r['root']} "
                               f"{r['seconds']:.1f} s" for r in runs))
    for cell in {c: 0 for r in runs for c in r["cells"]}:
        print(f"{cell}: " + " / ".join(
            f"{r['cells'][cell]:.4f}" if cell in r["cells"] else "-"
            for r in runs) + " ms (A B B A)")
    for key in runs[0]["memory"]:
        print(f"memory {key}: " + " / ".join(
            f"{r['memory'][key]['reserved_gib']:.2f} reserved, "
            f"{r['memory'][key]['allocated_gib']:.2f} allocated"
            for r in runs) + " GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
