"""End-to-end training with checkpoint/restart fault tolerance
(port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
        [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given (and raises when
there is none); on the card every steady step is one replay of a captured
CUDA graph (``train.train_step``).  Fault-tolerance contract, as the
reference's:

* atomic checkpoints every ``--ckpt-every`` steps (async write);
* on start, the latest checkpoint (params, opt state, pipeline cursor) is
  restored if present — crash/preemption recovery is just re-launching;
  a restore writes into the live tensors, so a captured step replays on;
* step-level exceptions trigger a restore-and-retry once before aborting
  (transient-failure mitigation; persistent failures abort loudly).

There is no mesh yet (the reference's ``shardctx``, ``launch/sharding``
and ``make_local_mesh`` placement come with the dry-run slice): on one
device the reference's mesh replicates everything, so the numbers are the
same.  A checkpoint holds ``{"params": {name: tensor}, "opt": {m, v,
step}}`` in the reference's on-disk format.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.base import get_config
from ..data.pipeline import TokenPipeline
from ..device import resolve
from ..models.model import build_model
from ..train import checkpoint as ck
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.train_step import make_train_step

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = init_opt_state(params)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1))
    pipe = TokenPipeline(cfg, args.batch, args.seq, device=dev)
    # the live training state, as a checkpoint holds it
    live = {"params": dict(params.named_parameters()), "opt": opt_state}

    mgr = ck.CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None:
        restored, manifest = mgr.restore_latest(into=live)
        if restored is not None:
            pipe.restore(manifest["extra"]["pipeline"])
            start = manifest["step"]
            print(f"[train] restored step {start} from {args.ckpt_dir}")

    step_fn = make_train_step(model, opt_cfg, n_micro=args.n_micro)

    t0 = time.time()
    step = start
    retried = False
    metrics = None
    while step < args.steps:
        batch = pipe.next()
        try:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        except Exception as e:  # transient-failure path: restore, retry
            if retried or mgr is None:
                raise
            print(f"[train] step {step} failed ({e}); restoring")
            _, manifest = mgr.restore_latest(into=live)
            pipe.restore(manifest["extra"]["pipeline"])
            step = manifest["step"]
            retried = True
            continue
        step += 1
        if step % args.log_every == 0 or step == args.steps:
            loss = float(metrics["loss"])
            dt = (time.time() - t0) / max(step - start, 1)
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        if mgr is not None and step % args.ckpt_every == 0:
            mgr.save(step, live, extra={"pipeline": pipe.state()})
    if mgr is not None:
        mgr.save(args.steps, live, extra={"pipeline": pipe.state()},
                 blocking=True)
        mgr.wait()
    return None if metrics is None else float(metrics["loss"])


if __name__ == "__main__":
    main()
