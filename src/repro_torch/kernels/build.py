"""Build and load the CUDA kernels of this package, at first use.

Every source under ``csrc/`` is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds).  The library lands in
``build/kernels/`` at the root of the checkout (git-ignored), named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached file.  A failed build raises; nothing falls
back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["library", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VOID = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_SIGNATURES = {
    "wr_tile": ([], _INT),
    "wr_max_window": ([], _LL),
    "wr_prefix_scan_f32": ([_VOID, _VOID, _VOID, _LL, _LL, _VOID], _INT),
    "wr_prefix_scan_bf16": ([_VOID, _VOID, _VOID, _LL, _LL, _VOID], _INT),
    "wr_sliding_assoc_f32": ([_VOID, _VOID, _LL, _LL, _INT, _INT, _VOID],
                             _INT),
    "sd_max_rows": ([], _INT),
    "sd_seg_dirty": ([_VOID, _VOID, _VOID, _INT, _LL, _INT, _LL, _LL, _LL,
                      _LL, _VOID, _INT, _VOID], _INT),
    "ft_max_window": ([], _LL),
    "ft_fused_trend": ([_VOID, _VOID, _VOID, _LL, _INT, _INT, _VOID], _INT),
}


class _Library:
    """The loaded kernel library plus what its build reported."""

    def __init__(self):
        self.lib = None
        self.path = None
        self.build_seconds = 0.0   # 0.0 when a cached library was loaded
        self.build_log = ""        # nvcc/ptxas output (registers, smem)

    def load(self):
        if self.lib is not None:
            return self.lib
        sources = sorted(CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in sorted(CSRC.iterdir()):
            h.update(s.name.encode())
            h.update(s.read_bytes())
        path = BUILD_DIR / f"libreprokernels_{h.hexdigest()[:16]}.so"
        if not path.exists():
            self._build(sources, path)
        lib = ctypes.CDLL(str(path))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        self.lib, self.path = lib, path
        return lib

    def _build(self, sources, path: Path):
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is None:
            raise RuntimeError("no CUDA toolkit found (nvcc): cannot build "
                               "the repro_torch kernels")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            objs = [os.path.join(work, src.stem + ".o") for src in sources]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objs)]
            logs = [p.communicate()[0] for p in procs]
            self.build_log = "".join(logs)
            failed = [src.name for src, p in zip(sources, procs)
                      if p.returncode != 0]
            if failed:
                raise RuntimeError(
                    f"nvcc failed on {failed}:\n{self.build_log}")
            tmp = os.path.join(work, path.name)
            res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
            self.build_log += res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({res.returncode}):\n"
                    f"{self.build_log}")
            os.replace(tmp, path)  # atomic: a concurrent load never sees half
        self.build_seconds = time.perf_counter() - t0


library = _Library()
