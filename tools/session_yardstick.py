#!/usr/bin/env python3
"""Why the 2**24-tick dashboard session chunk, the yardstick of
``chip_smoke.py``'s ``shard_union_run`` cell, reads slower in phase 11
than on its own, on a card.

    python3 tools/session_yardstick.py

One process, on a 1-rank NCCL mesh, with phase 11's data: the session's
one chunk (``reset`` then ``run``) timed ``REPS`` times at each step,
each time beside what the caching allocator did during it (device
allocations and frees, allocation retries) and the garbage collections
Python ran in it:

1. fresh;
2. after ``chip_smoke.mesh_one_shot`` (phase 11's ``shard_map_run`` cells);
3. after ``gc.collect()`` and ``torch.cuda.empty_cache()``;
4. in turns with ``shard_union_run`` (session, union, union, session), the
   union's first call (its capture) just before, as ``chip_smoke.py``'s
   ``mesh_union`` runs them;
5. with garbage collection off.

Then the device busy time and idle share of one session chunk by
``torch.profiler``.  Prints one line per step, with the card's name and
power limit.
"""
import gc
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

REPS = 6


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("session_yardstick: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.data import apps as A
    from repro_torch.kernels.build import library
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.multiquery import shard_union_run
    library.load()
    dev = torch.device("cuda")
    print(cs.card_line())
    mesh = make_local_mesh()
    rng = np.random.default_rng(7)
    vals = np.floor(rng.random(cs.MQ_TICKS) * 16).astype(np.float32)
    grids = {"in": cs._grid(vals, dev)}
    qs = A.dashboard_queries(cs.MQ_QUERIES)
    sess = cs._dash_session(qs, cs.MQ_TICKS, 1, False)

    def local():
        sess.reset()
        return sess.run(grids, 1)

    def union():
        return shard_union_run(qs, cs.MQ_TICKS, grids, mesh)

    def timed(fn):
        """ms of ``fn()``, and what the allocator and the collector did."""
        keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
        s0 = torch.cuda.memory_stats()
        g0 = sum(s["collections"] for s in gc.get_stats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        s1 = torch.cuda.memory_stats()
        g1 = sum(s["collections"] for s in gc.get_stats())
        return ms, tuple(s1.get(k, 0) - s0.get(k, 0) for k in keys), g1 - g0

    def show(step: str, rows) -> None:
        print(f"{step}: " + "; ".join(
            f"{what} {ms:.3f} ms (mallocs {a}, frees {f}, retries {r}, "
            f"gc {g})" for what, (ms, (a, f, r), g) in rows))

    local()                                      # first use
    show("1 fresh", [("session", timed(local)) for _ in range(REPS)])
    cs.mesh_one_shot(dev, mesh, {}, {})
    show("2 after mesh_one_shot",
         [("session", timed(local)) for _ in range(REPS)])
    gc.collect()
    torch.cuda.empty_cache()
    show("3 after gc.collect and empty_cache",
         [("session", timed(local)) for _ in range(REPS)])
    union()                                      # first use: the capture
    rows = []
    for _ in range(REPS // 2):
        for what, fn in (("session", local), ("union", union),
                         ("union", union), ("session", local)):
            rows.append((what, timed(fn)))
    show("4 in turns with shard_union_run", rows)
    gc.disable()
    try:
        show("5 gc off", [("session", timed(local)) for _ in range(REPS)])
    finally:
        gc.enable()
    ms = timed(local)[0]
    print(f"6 one session chunk: {cs._profile_text(cs.device_profile(local, ms / 1e3))}"
          f" (wall {ms:.3f} ms)")
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
