#!/usr/bin/env python3
"""Where the ``fused_trend`` kernel spends its time, on a card.

    python3 tools/fused_trend_variants.py [T w1 w2]

No kernel profiler works on the card this port is measured on, so this
builds variants of ``src/repro_torch/kernels/csrc/fused_query.cu`` into
stand-alone programs (under ``build/variants/``, git-ignored) and times
each over ``T`` ticks (default 2**24) at windows ``w1, w2`` (default 20,
50), with the launch plan of ``fused_query.trend_plan``:

* ``full``: the kernel as it is;
* ``no_scans``: without the two segmented sums (the outputs are formed
  from the staged ticks in their place);
* ``no_output``: the sums, with the outputs' computation and stores cut;
* ``copy_only``: staging, then each thread's ticks stored as ``diff``
  (two float4 stores a thread, as the kernel stores its outputs).

The differences attribute the kernel's time to its phases.  Each line
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
  const long long T = %(T)d;
  float *x, *diff;
  unsigned char* up;
  cudaMalloc(&x, T * 4);
  cudaMalloc(&diff, T * 4);
  cudaMalloc(&up, T);
  cudaMemset(x, 0, T * 4);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  int e = ft_fused_trend(x, diff, up, T, %(w1)d, %(w2)d, %(span)d,
                         %(blocks)d, %(smem)d, 0, 0);
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < 50; ++i)
    ft_fused_trend(x, diff, up, T, %(w1)d, %(w2)d, %(span)d, %(blocks)d,
                   %(smem)d, 0, 0);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  printf("%%-10s T=%%lld w=%(w1)d,%(w2)d: %%.4f ms (launch error %%d)\n",
         "%(name)s", T, ms / 50, e);
  return 0;
}
'''

COPY = """    if (wide && base + i0 + FT_ITEMS <= n_out) {
      float4* dv = reinterpret_cast<float4*>(diff + o0 + base + i0);
      dv[0] = make_float4(v[0], v[1], v[2], v[3]);
      dv[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
"""


def variants(src: str) -> dict:
    """The kernel source with its sums, its outputs, or both cut."""
    out = src[src.index("    if (base + i0 < n_out)\n      write_outputs("):]
    out = out[:out.index(";\n") + 2]
    sums = ["    seg_sum<true>(v, m, carry, wt, wf, wp);\n",
            "    seg_sum<false>(v, m, carry, wt, wf, wp);\n"]
    for line in sums:
        assert line in src, line
    no_sums = src
    for line in sums:
        no_sums = no_sums.replace(line, "")
    return {"full": src, "no_scans": no_sums,
            "no_output": src.replace(out, ""),
            "copy_only": no_sums.replace(out, COPY)}


def main() -> int:
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels import fused_query as fq
    T, w1, w2 = (int(a) for a in sys.argv[1:4]) if len(sys.argv) > 3 else (
        1 << 24, 20, 50)
    plan = fq.trend_plan(T, w2)
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    src = (csrc / "fused_query.cu").read_text()
    out = ROOT / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    procs = {}
    for name, text in variants(src).items():
        cu = out / f"trend_{name}.cu"
        cu.write_text(text + MAIN % dict(T=T, w1=w1, w2=w2, name=name,
                                          span=plan.span, blocks=plan.blocks,
                                          smem=plan.smem))
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xptxas", "-v", "-I", str(csrc), "-o",
             str(out / f"trend_{name}"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"{name}: {regs[-1] if regs else ''}")
    for name in procs:
        subprocess.run([str(out / f"trend_{name}")], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
