"""Train a language model end to end on the PyTorch port (token pipeline →
train step on a one-rank mesh → checkpoints).

Default is a ~10M-parameter qwen3-family model for 100 steps;
``--full-100m`` selects a ~100M config (the reference's full scale).
`repro_torch.launch.train` trains on a one-rank mesh: NCCL on the card,
gloo on the CPU; on the card the train step is captured as a CUDA graph
after its first, eager, step.

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--full-100m]
      [--steps N] [--ckpt-dir DIR] [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
A checkpoint directory that already holds the last step resumes there
and trains no further.
"""
import argparse
import os
import tempfile

from repro_torch import device as D
from repro_torch.configs import base as cb
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as T


def config(full: bool) -> ModelConfig:
    if full:  # ~100M params
        return ModelConfig(
            name="demo-100m", family="dense", n_layers=12, d_model=768,
            n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32_000,
            pattern=("global",), qk_norm=True, mlp_act="silu",
            tie_embeddings=True)
    return ModelConfig(  # ~10M params
        name="demo-10m", family="dense", n_layers=6, d_model=256,
        n_heads=8, n_kv_heads=4, d_ff=688, vocab=8_192,
        pattern=("global",), qk_norm=True, mlp_act="silu",
        tie_embeddings=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "tiltx_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    D.resolve(args.device)      # no card and no --device cpu: raise here

    cfg = config(args.full_100m)
    print(f"[example] {cfg.name}: {cfg.n_params()/1e6:.1f}M params")

    # register the demo config so the production driver can find it
    cb.register(cfg.name, cfg, cfg)

    loss = T.main([
        "--arch", cfg.name, "--steps", str(args.steps),
        "--batch", "8", "--seq", "256", "--lr", "3e-3",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
    ] + (["--device", args.device] if args.device else []))
    print(f"[example] final loss {loss:.4f}")
    return {"arch": cfg.name, "n_params": cfg.n_params(), "final_loss": loss}


if __name__ == "__main__":
    main()
