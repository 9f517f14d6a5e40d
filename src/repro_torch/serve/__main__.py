"""``python -m repro_torch.serve`` — smoke-run the serving loop and gate it
(port of ``python -m repro.serve``).

``--smoke`` builds the fraud demo query into a served runner (cold, or warm
from ``--cache-dir``), serves a few chunks through the double-buffered
loop and gates the steady state: the tail after the first two chunks runs
under ``torch.cuda.set_sync_debug_mode("error")`` (any synchronizing call
raises), and no CUDA graph may be captured after warm-up.  Exit 1 if
either fails.  The reference gates with its ``serving`` analysis pass
instead, which waits for the port of the analysis layer (ROADMAP A15).

Run it twice with the same ``--cache-dir``: the second run prints
``plan=warm`` (its runner rebuilt from the persisted plan artifact and
capture manifests, its graphs captured anew).  ``--device cpu`` runs the
eager CPU path, where there is nothing to capture or synchronize.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _fraud(win: int = 16):
    from ..core.frontend import TStream
    s = TStream.source("in", prec=1)
    mu = s.window(win).mean().shift(1)
    sd = s.window(win).stddev().shift(1)
    thr = mu.join(sd, lambda m, d: m + 3.0 * d)
    return s.join(thr, lambda x, t: x - t).where(lambda e: e > 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Serving-loop smoke + steady-state gate.")
    ap.add_argument("--smoke", action="store_true",
                    help="small end-to-end loop (the gate)")
    ap.add_argument("--cache-dir", default="out/serve_cache",
                    help="persisted plan/capture cache directory "
                         "(default: out/serve_cache)")
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--out-len", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("nothing to do (pass --smoke)")

    import torch

    from ..core.stream import SnapshotGrid
    from ..device import resolve
    from .loop import build_service

    dev = resolve(args.device)
    t0 = time.perf_counter()
    svc = build_service(_fraud(), out_len=args.out_len, segs_per_chunk=2,
                        cache_dir=args.cache_dir, device=dev)
    span = svc.runner.n_segs * svc.runner.spec.span
    rng = np.random.default_rng(3)

    def chunk(i):
        # host numpy on purpose: the loop's pinned, side-stream copy is
        # the only transfer to the card on the steady path
        v = rng.integers(0, 100, span).astype(np.float32)
        return {"in": SnapshotGrid(value=v, valid=np.ones(span, bool),
                                   t0=i * span, prec=1)}

    gen = svc.serve(chunk(i) for i in range(args.chunks))
    next(gen)
    t_first = time.perf_counter() - t0
    next(gen)
    tracer = svc.runner.metrics.tracer
    captured = tracer.captures()
    sync_error = None
    served = 2
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
    try:
        served += sum(1 for _ in gen)
    except RuntimeError as e:
        sync_error = str(e)
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
    late = {k: n - captured.get(k, 0) for k, n in tracer.captures().items()
            if n != captured.get(k, 0)}
    how = {}
    for v in svc.aot_report.values():
        how[v] = how.get(v, 0) + 1
    print(f"[serve --smoke] plan={svc.plan_source} "
          f"aot={{{', '.join(f'{k}: {n}' for k, n in sorted(how.items()))}}}"
          f" chunks={served} first_result={t_first * 1e3:.0f}ms "
          f"captures={sum(captured.values())} "
          f"captures_after_warmup={late or '{}'} "
          f"steady_syncs={'error: ' + sync_error if sync_error else 0} "
          f"device={dev}")
    return 1 if (sync_error or late) else 0


if __name__ == "__main__":
    sys.exit(main())
