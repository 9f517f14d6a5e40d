#!/usr/bin/env python3
"""Drive the PyTorch port's TiLT query path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. Print the card's name and power limit, build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, at the
   apps' windows, at edge shapes and at the main path's shapes; time the
   kernel, the plain version and one PyTorch library call that computes
   the same function (CUDA events, median of repeats).
3. The main path, single stream: every app of ``repro_torch.data.apps``
   through ``compile_query`` -> ``partition_run`` over 2**24 ticks held on
   the card, in 16 partitions of 2**20 ticks; ysb once more with the
   subtract-on-evict sum.  The first two partitions are compared with the
   same query run on the CPU (plain versions) at identical partitioning.
4. The main path, keyed: trend, fraud and ysb through ``batch_run`` at 4096
   keys x 4096 ticks, the first 64 keys compared with the CPU.
   In phases 3-4 the launch counts are set to 0 just before each timed
   ``partition_run``/``batch_run`` and read just after it; the warm-up
   call before it and the ``torch.profiler`` run after it (one partition
   or batch: device busy time, idle share, top kernels) are outside.
5. One JSON line with every kernel's launches on the main path (the sum
   of those windows), its error against its plain version, its times and
   its bound.
6. The last line: ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

EPS32 = float(np.finfo(np.float32).eps)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
N_TICKS = 1 << 24
PART = 1 << 20
N_CMP_PARTS = 2
KEYS, KEY_TICKS, CMP_KEYS = 4096, 4096, 64


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(got, want) -> float:
    """Largest |got - want|, counting equal infinities as 0."""
    import torch
    d = (got.double() - want.double()).abs()
    d = torch.where(got == want, torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def sum_check(what: str, got, plain, exact, scale=None) -> float:
    """Hold a summing kernel against its plain version.  Both add in f32,
    in different orders, so each is held against the f64 result ``exact``:
    the kernel may be at most twice as far from it as the plain version
    is, plus 4 ulps of the largest sum it forms (``scale``; by default the
    largest exact value).  Returns max |kernel - plain|."""
    e_k, e_p = max_err(got, exact), max_err(plain, exact)
    if scale is None:
        scale = float(exact.abs().max())
    tol = 2 * e_p + 4 * EPS32 * scale
    if not e_k <= tol:
        raise AssertionError(f"{what}: |kernel - f64| {e_k} > {tol} "
                             f"(plain version {e_p})")
    return max_err(got, plain)


def exact_check(what: str, got, plain) -> float:
    """max/min select one of their inputs: kernel and plain version agree
    exactly."""
    e = max_err(got, plain)
    if e != 0.0:
        raise AssertionError(f"{what}: |kernel - plain| {e} != 0")
    return e


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref, window_reduce as wr

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, scale=1.0, offset=0.0):
        return (torch.randn(*shape, generator=gen) * scale + offset).to(dev)

    errs = {"prefix_scan": 0.0, "sliding_assoc": 0.0}

    # sliding_assoc: the apps' windows and the edges (W = 8, 37, W > T,
    # T not a multiple of W)
    cases = [(3, 100_003, w) for w in (20, 30, 50, 100, 400, 1000)]
    cases += [(1, 64, 8), (3, 533, 37), (2, 96, 256), (1, 100, 100),
              (2, 5000, 3001), (2, 40_000, 2048)]
    for R, T, W in cases:
        x = randn(R, T, scale=3.0)
        what = f"sliding_assoc ({R},{T}) W={W}"
        for op in ("add", "max", "min"):
            combine, ident, _ = wr.COMBINES[op]
            got = wr.sliding_assoc(x, W, op)
            plain = ref.sliding_assoc_block_ref(x, W, combine, ident)
            if op == "add":
                exact = ref.sliding_assoc_block_ref(x.double(), W, torch.add,
                                                    0.0)
                e = sum_check(what + " add", got, plain, exact)
            else:
                e = exact_check(f"{what} {op}", got, plain)
            errs["sliding_assoc"] = max(errs["sliding_assoc"], e)
    log(f"sliding_assoc: {len(cases) * 3} cases agree with the plain "
        f"version (max err {errs['sliding_assoc']:.3g})")

    # prefix_scan: f32 accumulation of f32 or bf16 rows
    for R, T in [(1, 10), (3, 1025), (2, 100_003), (6, PART + 49)]:
        x = randn(R, T)
        for dt in (torch.float32, torch.bfloat16):
            xi = x.to(dt).contiguous()
            got = wr.prefix_scan(xi)
            if got.dtype != torch.float32:
                raise AssertionError(f"prefix_scan {dt}: out {got.dtype}")
            e = sum_check(f"prefix_scan {dt} ({R},{T})", got,
                          ref.prefix_sum_ref(xi.float()),
                          torch.cumsum(xi.double(), dim=-1))
            errs["prefix_scan"] = max(errs["prefix_scan"], e)
    # W < 8 sums take the prefix-scan path through ops.sliding_sum: the
    # prefix sums P are what is rounded, P[t] - P[t-W] what is compared
    for W in (1, 3, 7):
        x = randn(2, 50_000, scale=2.0)
        valid = (torch.rand(50_000, generator=gen) > 0.2).to(dev)
        s, n = ops.sliding_sum(x, valid, W)
        sr, nr = ref.sliding_sum_ref(x, valid, W)
        p = torch.cumsum(torch.where(valid, x, 0.0).double(), dim=-1)
        e = sum_check(f"ops.sliding_sum W={W}", s, sr,
                      p - ref.shift_right(p, W, 0.0),
                      scale=float(p.abs().max()))
        exact_check(f"ops.sliding_sum W={W} count", n, nr)
        errs["prefix_scan"] = max(errs["prefix_scan"], e)
    log(f"prefix_scan: f32/bf16 and W<8 sums agree with the plain version "
        f"(max err {errs['prefix_scan']:.3g})")

    # times at the main path's shapes (rows = keys x (channels + 1),
    # T = partition length + halo): trend's 50-tick mean on one stream and
    # on 4096 keys; ysb's subtract-on-evict count.
    torch.backends.cudnn.allow_tf32 = False   # the f32 yardstick stays f32
    rows = {}
    x1 = randn(2, PART + 49, scale=0.05, offset=100.0)
    xk = randn(2 * KEYS, KEY_TICKS + 49, scale=0.05, offset=100.0)
    ones = torch.ones(1, 1, 50, device=dev)
    for label, x in (("single", x1), ("keyed", xk)):
        R, T = x.shape
        e = sum_check(f"sliding_assoc add {label}",
                      wr.sliding_assoc(x, 50, "add"),
                      ref.sliding_assoc_block_ref(x, 50, torch.add, 0.0),
                      ref.sliding_assoc_block_ref(x.double(), 50, torch.add,
                                                  0.0))
        errs["sliding_assoc"] = max(errs["sliding_assoc"], e)
        t = {
            "ms": cuda_ms(lambda: wr.sliding_assoc(x, 50, "add")),
            "plain_ms": cuda_ms(lambda: ref.sliding_assoc_block_ref(
                x, 50, torch.add, 0.0)),
            # trailing 50-tick sums in one call: conv1d with a ones filter
            "library_ms": cuda_ms(lambda: F.conv1d(
                x.unsqueeze(1), ones, padding=49)),
        }
        b, by = bound(8.0 * R * T, 2.0 * R * T)
        rows[("sliding_assoc", label)] = dict(t, max_abs_err=e, bound_ms=b,
                                              bound_by=by, shape=[R, T],
                                              window=50)
        xp = F.pad(x, (49, 0), value=-float("inf"))
        tmax = cuda_ms(lambda: wr.sliding_assoc(x, 50, "max"))
        tpool = cuda_ms(lambda: F.max_pool1d(xp.unsqueeze(1), 50, stride=1))
        log(f"sliding_assoc {label} ({R},{T}) W=50: add {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, conv1d {t['library_ms']:.4f} ms;"
            f" max {tmax:.4f} ms, max_pool1d {tpool:.4f} ms; bound "
            f"{b:.4f} ms ({by})")
    for label, (R, T) in (("single", (2, PART + 9)),
                          ("keyed", (2 * KEYS, KEY_TICKS + 9))):
        x = (torch.rand(R, T, generator=gen) < 0.33).float().to(dev)
        e = sum_check(f"prefix_scan {label}", wr.prefix_scan(x),
                      ref.prefix_sum_ref(x), torch.cumsum(x.double(), -1))
        errs["prefix_scan"] = max(errs["prefix_scan"], e)
        t = {
            "ms": cuda_ms(lambda: wr.prefix_scan(x)),
            "plain_ms": cuda_ms(lambda: ref.prefix_sum_ref(x)),
            "library_ms": cuda_ms(lambda: torch.cumsum(x, dim=-1)),
        }
        b, by = bound(8.0 * R * T, 1.0 * R * T)
        rows[("prefix_scan", label)] = dict(t, max_abs_err=e, bound_ms=b,
                                            bound_by=by, shape=[R, T])
        log(f"prefix_scan {label} ({R},{T}): {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, cumsum {t['library_ms']:.4f} ms; "
            f"bound {b:.4f} ms ({by})")
    return errs, rows


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------

def _leaves(v) -> dict:
    return ({k: a.detach().cpu().numpy() for k, a in v.items()}
            if isinstance(v, dict) else {"v": v.detach().cpu().numpy()})


def compare(name: str, got, want) -> dict:
    """Hold a card output grid against the CPU's (both already cut to the
    compared region) within the app's limits in
    ``repro_torch.data.tolerance``."""
    from repro_torch.data import tolerance
    return tolerance.compare(name, got.valid.cpu().numpy(),
                             _leaves(got.value), want.valid.cpu().numpy(),
                             _leaves(want.value))


def drive(main_launches: dict, fn):
    """One call on the main path: every launch count is set to 0 just
    before it and read just after, once the card has finished, and added
    to ``main_launches``.  Returns the call's result and seconds."""
    import torch
    from repro_torch.kernels import window_reduce as wr
    torch.cuda.synchronize()
    wr.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k, n in wr.launches.items():
        main_launches[k] = main_launches.get(k, 0) + n
    return res, dt


def device_profile(fn, wall_s: float) -> dict:
    """Device time of one call by ``torch.profiler``, outside any launch
    count window: the busy time (union of kernel and copy intervals), the
    idle share against ``wall_s`` (the same call's time without the
    profiler) and the kernels that took most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, per_kernel = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        short = e.name.replace("(anonymous namespace)::", "")
        short = short.removeprefix("void ").split("<")[0].split("(")[0]
        short = short.split("::")[-1].strip()[:40]
        per_kernel[short] = (per_kernel.get(short, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    if not spans:
        return {"device_ms": None, "idle_share": None, "top": []}
    busy_us, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
    return {"device_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / (wall_s * 1e3)),
            "top": [[k, v] for k, v in top]}


def _profile_text(p: dict) -> str:
    if p["device_ms"] is None:
        return "device time not reported by torch.profiler"
    return (f"device busy {p['device_ms']:.4f} ms, idle share "
            f"{p['idle_share']:.3f}; " + ", ".join(
                f"{k} {v:.4f}" for k, v in p["top"]))


def run_apps(dev, main_launches: dict, n_ticks: int, part: int, n_cmp: int,
             seed: int = 0):
    """Every app over ``n_ticks`` in partitions of ``part`` ticks on the
    card; the first ``n_cmp`` partitions against the CPU."""
    from torch.utils._pytree import tree_map
    from repro_torch.core import compile as qc
    from repro_torch.core.parallel import partition_run
    from repro_torch.data import apps as A

    out = {}
    runs = [(name, "block") for name in A.APPS] + [("ysb", "soe")]
    for name, algo in runs:
        app = A.make_app(name)
        data = app.make_input(n_ticks, seed)
        grids = A.make_grids(data, device=dev)
        exe = qc.compile_query(app.query.node, out_len=part // app.query.prec,
                               sum_algo=algo)
        n_parts = n_ticks // part
        partition_run(exe, grids, 0, 1)          # first use of every shape
        res, dt = drive(main_launches,
                        lambda: partition_run(exe, grids, 0, n_parts))
        if res.valid.shape != (n_parts * exe.out_len,):
            raise AssertionError(f"{name}: output shape {res.valid.shape}")
        prof = device_profile(lambda: partition_run(exe, grids, 1, 1),
                              dt / n_parts)
        cpu = partition_run(exe, A.make_grids(data, device="cpu"), 0, n_cmp)
        k = n_cmp * exe.out_len
        head = res.replace(value=tree_map(lambda x: x[:k], res.value),
                           valid=res.valid[:k])
        stats = compare(name, head, cpu)
        out[f"{name}/{algo}"] = dict(stats, events_per_s=n_ticks / dt,
                                     seconds=dt, profile=prof)
        log(f"app {name:10s} {algo:5s}: {n_ticks / dt:.4g} events/s "
            f"({dt * 1e3:.2f} ms for {n_parts} partitions of {part}); "
            f"vs cpu max diff {stats['max_abs_diff']:.3g}, "
            f"{stats['flips']} gate flips")
        log(f"  one partition: {_profile_text(prof)}")
        del grids, res
    return out


def run_keyed(dev, main_launches: dict, n_keys: int, n_ticks: int,
              n_cmp: int, seed: int = 0):
    """Keyed trend, fraud and ysb through ``batch_run``; the first
    ``n_cmp`` keys against the CPU."""
    from torch.utils._pytree import tree_map
    from repro_torch.core import compile as qc
    from repro_torch.core.parallel import batch_run
    from repro_torch.data import apps as A

    out = {}
    for name in A.KEYED_APPS:
        app = A.make_keyed_app(name)
        data = app.make_keyed_input(n_keys, n_ticks, seed)
        grids = A.make_grids(data, device=dev)
        exe = qc.compile_query(app.query.node,
                               out_len=n_ticks // app.query.prec)
        batch_run(exe, grids)                    # first use of every shape
        res, dt = drive(main_launches, lambda: batch_run(exe, grids))
        if res.valid.shape != (n_keys, exe.out_len):
            raise AssertionError(f"{name}: output shape {res.valid.shape}")
        prof = device_profile(lambda: batch_run(exe, grids), dt)
        few = {nm: {"value": ({k: a[:n_cmp] for k, a in d["value"].items()}
                              if isinstance(d["value"], dict)
                              else d["value"][:n_cmp]),
                    "valid": d["valid"][:n_cmp]} for nm, d in data.items()}
        cpu = batch_run(exe, A.make_grids(few, device="cpu"))
        head = res.replace(value=tree_map(lambda x: x[:n_cmp], res.value),
                           valid=res.valid[:n_cmp])
        stats = compare(name, head, cpu)
        events = n_keys * n_ticks
        out[name] = dict(stats, events_per_s=events / dt, seconds=dt,
                         profile=prof)
        log(f"keyed {name:6s}: {events / dt:.4g} events/s ({dt * 1e3:.2f} "
            f"ms for {n_keys} keys x {n_ticks} ticks); vs cpu max diff "
            f"{stats['max_abs_diff']:.3g}, {stats['flips']} gate flips")
        log(f"  one batch: {_profile_text(prof)}")
        del grids, res
    return out


# ---------------------------------------------------------------------------

KERNELS = {
    "prefix_scan": ("src/repro_torch/kernels/csrc/window_reduce.cu",
                    "src/repro/kernels/window_reduce.py:78"),
    "sliding_assoc": ("src/repro_torch/kernels/csrc/window_reduce.cu",
                      "src/repro/kernels/window_reduce.py:127"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import window_reduce as wr
    from repro_torch.kernels.build import library

    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    library.load()
    log(f"kernels built in {library.build_seconds:.2f} s (load "
        f"{time.perf_counter() - t0:.2f} s): {library.path.name}")
    for line in library.build_log.splitlines():
        if "registers" in line:
            log("  " + line.strip())

    errs, rows = check_kernels(dev)

    single, keyed_launches = {}, {}
    apps = run_apps(dev, single, N_TICKS, PART, N_CMP_PARTS)
    for k in wr.launches:
        if single.get(k, 0) == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    keyed = run_keyed(dev, keyed_launches, KEYS, KEY_TICKS, CMP_KEYS)
    launches = {k: single.get(k, 0) + keyed_launches.get(k, 0)
                for k in wr.launches}
    log(f"main-path launches: partition_run {single}, batch_run "
        f"{keyed_launches}, total {launches}")

    Path("out").mkdir(exist_ok=True)
    detail = {"card": card, "apps": apps, "keyed": keyed,
              "kernels": {f"{k}/{lab}": v for (k, lab), v in rows.items()},
              "launches": {"partition_run": single, "batch_run": keyed_launches,
                           "total": launches}}
    Path("out/chip_smoke.json").write_text(json.dumps(detail,
                                                              indent=1))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[(name, "single")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
