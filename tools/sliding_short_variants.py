#!/usr/bin/env python3
"""Where the short-row ``sliding_assoc`` kernel spends its time, on a card.

    python3 tools/sliding_short_variants.py [R T W]

No kernel profiler works on the card this port is measured on, so this
builds three variants of ``src/repro_torch/kernels/csrc/window_reduce.cu``
into stand-alone programs (under ``build/variants/``, git-ignored) and times
each at ``(R, T)`` rows, window ``W`` (default: the keyed runner's larger
launch, 98304 x 129 at W = 64), with the launch plan of
``window_reduce.sliding_plan``:

* ``full``: the kernel as it is;
* ``forward_only``: without the backward (suffix) pass;
* ``copy_only``: staging and one store per tick, no scan at all.

The differences attribute the kernel's time to its passes.  Each line
prints the CUDA-event mean over 50 launches after one warm-up launch.
"""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MAIN = r'''
#include <cstdio>
int main() {
  const long long R = %(R)d, T = %(T)d;
  const int W = %(W)d;
  float *x, *out;
  cudaMalloc(&x, R * T * 4);
  cudaMalloc(&out, R * T * 4);
  cudaMemset(x, 0, R * T * 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  int e = wr_sliding_assoc_f32(x, out, R, T, W, 0, 0, %(blocks)d,
                               %(threads)d, %(param)d, %(smem)d, 0, 0);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < 50; ++i)
    wr_sliding_assoc_f32(x, out, R, T, W, 0, 0, %(blocks)d, %(threads)d,
                         %(param)d, %(smem)d, 0, 0);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  printf("%%-13s (%%lld, %%lld) W=%%d: %%.4f ms (launch error %%d)\n",
         "%(name)s", R, T, W, ms / 50, e);
  return 0;
}
'''


def variants(src: str) -> dict:
    """The kernel source with its backward pass, or both passes, cut."""
    bwd = src.index("    for (int c0 = top; c0 >= 0;) {")
    fwd = src.index("    __syncwarp();\n    // forward")
    loop = src.index("    for (int c0 = 0; c0 < T;) {")
    end = src.index("    __syncwarp();\n  }\n}", loop)
    copy = "    for (int p = lane; p < T; p += 32) o[p] = xs[p];\n"
    return {"full": src,
            "forward_only": src[:bwd] + src[fwd:],
            "copy_only": src[:bwd] + copy + src[end:]}


def main() -> int:
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import window_reduce as wr
    R, T, W = (int(a) for a in sys.argv[1:4]) if len(sys.argv) > 3 else (
        98304, 129, 64)
    plan = wr.sliding_plan(R, T, W)
    if plan.regime != "short":
        raise SystemExit(f"({R}, {T}) at W={W} is not a short-row launch")
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    src = (csrc / "window_reduce.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    procs = {}
    for name, text in variants(src).items():
        cu = out / f"{name}.cu"
        cu.write_text(text + MAIN % dict(R=R, T=T, W=W, name=name,
                                          blocks=plan.blocks,
                                          threads=plan.threads,
                                          param=plan.param, smem=plan.smem))
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-I", str(csrc), "-o", str(out / name), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
    for name in procs:
        subprocess.run([str(out / name)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
