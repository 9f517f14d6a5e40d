"""Serve a small model with batched requests (prefill + batched decode
loop, the decode step captured as a CUDA graph on the card) through the
PyTorch port's `repro_torch.launch.serve`.

Run:  PYTHONPATH=src python examples_torch/serve_lm.py [--arch qwen3-1.7b]
      [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
"""
import argparse

from repro_torch.launch import serve as S

GEN = 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    done = S.main(["--arch", args.arch, "--smoke", "--batch", "4",
                   "--prompt-len", "32", "--gen", str(GEN), "--requests",
                   "8"] + (["--device", args.device] if args.device else []))
    return {"sequences": len(done), "tokens": len(done) * GEN, "done": done}


if __name__ == "__main__":
    main()
