"""Multi-key, multi-query streaming analytics on the PyTorch port.

Part 1 — per-user fraud detection over many concurrent keyed sub-streams
(paper §6.2's partitioned-stream parallelism): the unified policy runner
(``Runner`` + ``ExecPolicy(keys="vmapped")``, the successor of the
deprecated KeyedEngine) advances all users at once, one step per time
partition over the (users, ticks) grid, carrying only each user's halo
tail between chunks.  Swapping ``body="sparse"`` or ``placement=mesh(...)``
into the policy composes change-compressed execution and key-axis
sharding onto the same runner — no separate entry points.

Part 2 — the serving scenario on top: a *dashboard fan-out* where several
queries (trend up/down, band breakout, momentum — differing only in their
final heads) watch the same keyed price source.  One MultiQuerySession
(the ``dag="union"`` corner of the policy space) serves all of them from a
single pass per chunk: the shared window aggregates are planned and
evaluated once, per-query heads fan out from them (repro_torch.multiquery).

Each part runs twice, as the reference does: a warm-up run, then the timed
run.  The warm-up builds every step (a built step is cached on the
executable, so a fresh runner over it reuses it).  On the card a runner
captures each step as a CUDA graph at the first chunk of a workspace and
replays it after that: the fresh fraud runner captures once in its first
timed chunk, and the session, reset in place, keeps its graphs and only
replays them.

Run:  PYTHONPATH=src python examples_torch/multikey_analytics.py [n_users]
      [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
"""
import argparse
import time

import numpy as np

from repro_torch import device as D
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.data import apps as A
from repro_torch.engine import ExecPolicy, Runner, keyed_grid
from repro_torch.multiquery import MultiQuerySession

N_TICKS = 50_000
N_PARTS = 10  # stream consumed in 5k-tick chunks with carried halo state


def fraud_demo(n_users: int, dev) -> dict:
    # per-user trailing-stats fraud rule (Table 2's banking app)
    s = TStream.source("amt", prec=1, keyed=True)
    mu = s.window(1000).mean().shift(1)
    sd = s.window(1000).stddev().shift(1)
    thr = mu.join(sd, lambda m, d: m + 3.0 * d)
    q = s.join(thr, lambda x, t: x - t).where(lambda e: e > 0)

    exe = qc.compile_query(q.node, out_len=N_TICKS // N_PARTS)
    policy = ExecPolicy(keys="vmapped")    # dense × vmapped × local × solo

    rng = np.random.default_rng(0)
    amounts = rng.lognormal(3.0, 1.0, (n_users, N_TICKS)).astype(np.float32)
    fraud_mask = rng.random((n_users, N_TICKS)) < 0.001
    amounts[fraud_mask] *= 40.0

    grid = {"amt": keyed_grid(amounts, np.ones((n_users, N_TICKS), bool),
                              device=dev)}

    Runner(exe, policy, n_keys=n_users).run(grid, N_PARTS)    # warm-up
    D.synchronize(dev)

    engine = Runner(exe, policy, n_keys=n_users)
    t0 = time.perf_counter()
    out = engine.run(grid, N_PARTS)
    D.synchronize(dev)
    dt = time.perf_counter() - t0

    hits = out.valid.cpu().numpy()
    injected = int(fraud_mask.sum())
    caught = int((hits & fraud_mask).sum())
    rate = n_users * N_TICKS / dt
    print(f"[multikey] {n_users} users x {N_TICKS} ticks "
          f"({N_PARTS} chunks) = {rate/1e6:.1f}M ev/s on {D.name(dev)}")
    print(f"[multikey] flagged {int(hits.sum())} events; "
          f"caught {caught}/{injected} injected frauds "
          f"({100*caught/max(injected,1):.0f}% recall)")
    return {"events_per_s": rate, "flagged": int(hits.sum()),
            "caught": caught, "injected": injected, "out": out,
            "fraud_mask": fraud_mask}


def dashboard_demo(n_users: int, dev, n_queries: int = 8) -> dict:
    """N dashboard queries × K keyed sub-streams, one session, one pass."""
    queries = A.dashboard_queries(n_queries, keyed=True)
    data = A.dashboard_keyed_input(n_users, N_TICKS, seed=3)["in"]
    grid = {"in": keyed_grid(np.asarray(data["value"], np.float32),
                             data["valid"], device=dev)}

    span = N_TICKS // N_PARTS
    session = MultiQuerySession(span, n_keys=n_users)
    for name, q in queries.items():
        session.attach(name, q)
    rep = session.sharing_report()

    session.run(grid, N_PARTS)             # warm-up
    D.synchronize(dev)

    session.reset()
    t0 = time.perf_counter()
    outs = session.run(grid, N_PARTS)
    D.synchronize(dev)
    dt = time.perf_counter() - t0

    rate = n_queries * n_users * N_TICKS / dt
    print(f"[dashboard] {n_queries} queries x {n_users} symbols x "
          f"{N_TICKS} ticks ({N_PARTS} chunks) = "
          f"{rate/1e6:.1f}M query-events/s aggregate on {D.name(dev)}")
    print(f"[dashboard] union DAG: {rep.union_nodes} nodes "
          f"({rep.shared_nodes} shared) vs {rep.independent_nodes} "
          f"if run independently — sharing ratio {rep.sharing_ratio:.2f}x")
    heads = {}
    for name, out in outs.items():
        m = out.valid.cpu().numpy()
        v = out.value.cpu().numpy()
        fired = int(m.sum())
        mean = float(v[m].mean()) if fired else float("nan")
        heads[name] = {"fired": fired, "mean": mean}
        print(f"[dashboard]   {name}: {fired} valid ticks, "
              f"mean output {mean:.3f}")
    return {"query_events_per_s": rate, "union_nodes": rep.union_nodes,
            "shared_nodes": rep.shared_nodes,
            "independent_nodes": rep.independent_nodes,
            "sharing_ratio": rep.sharing_ratio, "heads": heads,
            "outs": outs}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_users", nargs="?", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)
    return {"fraud": fraud_demo(args.n_users, dev),
            "dashboard": dashboard_demo(args.n_users, dev)}


if __name__ == "__main__":
    main()
