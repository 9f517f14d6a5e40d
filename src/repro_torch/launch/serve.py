"""Batched serving loop: prefill + decode with continuous batching
(port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

It runs on the CUDA card unless ``--device cpu`` is given (and raises
when there is none).  A request queue feeds fixed-batch waves, in arrival
order; the scheduler is host-side, the steps are ``make_serve_steps``'s:
an eager prefill, then ``gen - 1`` greedy decode steps, each one replay of
the wave shape's captured graph on the card.  The generated tokens stay on
the device until the wave ends: one host read per wave.

Unlike the reference's loop, whisper's prefill sizes its caches for
``prompt_len + gen`` tokens, as every other family's does: the
reference's encdec prefill sizes them for the prompt alone, so each of its
decode writes lands, clamped, on the last slot.
"""
from __future__ import annotations

import argparse
import collections
import time
from typing import Optional

import numpy as np
import torch

from ..configs.base import get_config
from ..device import resolve
from ..models.model import Model, build_model
from ..train.train_step import make_serve_steps

__all__ = ["serve_waves", "main"]


def serve_waves(model: Model, params, requests, batch: int, prompt_len: int,
                gen: int, frames: Optional[torch.Tensor] = None,
                stats: Optional[dict] = None, steps=None):
    """Serve ``requests`` (token-id arrays of ``prompt_len``) greedily in
    waves of ``batch`` (the last wave padded with zero prompts), ``gen``
    tokens each.  ``frames`` (batch, enc_seq, D): the encdec input.
    Returns the generated tokens of every request, in order.

    ``stats`` (a dict) receives, on the card, CUDA-event times read after
    each wave's host read: ``prefill_ms`` per wave and ``decode_ms`` per
    step.  ``steps``: a ``make_serve_steps`` pair to reuse (its graphs)."""
    cfg, dev = model.cfg, model.device
    is_encdec = cfg.family == "encdec"
    prefill_fn, decode_fn = steps or make_serve_steps(model)
    max_len = prompt_len + gen
    timed = stats is not None and dev.type == "cuda"
    if stats is not None:
        stats.setdefault("prefill_ms", [])
        stats.setdefault("decode_ms", [])
    queue = collections.deque(requests)
    done = []
    while queue:
        # FIFO: serve in arrival order
        wave = [queue.popleft() for _ in range(min(batch, len(queue)))]
        n_real = len(wave)
        while len(wave) < batch:  # pad the batch
            wave.append(np.zeros(prompt_len, np.int64))
        tokens = torch.from_numpy(np.stack(wave).astype(np.int32)).to(dev)
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(gen + 1)] if timed else None
        if timed:
            marks[0].record()
        if is_encdec:
            logits, caches, enc = prefill_fn(params, tokens, frames,
                                             max_len=max_len)
            rest = (enc,)
        else:
            logits, caches = prefill_fn(params, tokens, max_len=max_len)
            rest = ()
        out = torch.empty((batch, gen), dtype=torch.int64, device=dev)
        out[:, 0] = torch.argmax(logits[:, -1], dim=-1)
        if timed:
            marks[1].record()
        pos = torch.full((), prompt_len, dtype=torch.int32, device=dev)
        for i in range(1, gen):
            logits, caches = decode_fn(params, caches, out[:, i - 1:i], pos,
                                       *rest)
            out[:, i] = torch.argmax(logits[:, 0], dim=-1)
            pos.add_(1)
            if timed:
                marks[i + 1].record()
        gen_np = out.cpu().numpy()          # the wave's one host read
        done.extend(gen_np[:n_real].tolist())  # padding slots are not work
        if timed:
            stats["prefill_ms"].append(marks[0].elapsed_time(marks[1]))
            stats["decode_ms"].extend(marks[i].elapsed_time(marks[i + 1])
                                      for i in range(1, gen))
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    rng = np.random.default_rng(0)
    requests = [rng.integers(0, cfg.vocab, args.prompt_len)
                for _ in range(args.requests)]
    frames = (torch.zeros((args.batch, cfg.enc_seq, cfg.d_model),
                          dtype=torch.float32, device=dev)
              if cfg.family == "encdec" else None)

    t0 = time.time()
    done = serve_waves(model, params, requests, args.batch, args.prompt_len,
                       args.gen, frames)
    dt = time.time() - t0
    n_tok = len(done) * args.gen
    print(f"[serve] {len(done)} sequences, {n_tok} tokens, "
          f"{n_tok/dt:.1f} tok/s, sample: {done[0][:8]}")
    return done


if __name__ == "__main__":
    main()
