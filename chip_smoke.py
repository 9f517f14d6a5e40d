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
5. The chunked runner, single stream (``repro_torch.engine.Runner``): the
   fraud-style query of the reference's sparse benchmark over a 2**24-tick
   burst stream (1% of ticks change, bursts of 128), 512-tick segments,
   256 segments (2**17 ticks) per chunk, 128 chunks, at ``body="dense"``
   and ``body="sparse"``; then the trend app at 2**24 ticks, where every
   segment is dirty (the full-capacity bucket), at both bodies.
6. The runner, keyed: the keyed fraud query at 16384 keys (1% and 100% of
   the keys active), 64-tick segments, 2 per chunk, 16 chunks, at both
   bodies.
7. The one-shot ``sparse_run``: the fraud query over a 2**20-tick burst
   stream at 1%, 512-tick segments, against ``partition_run``.
   Phases 5-7 check that the sparse output equals the dense one bit for
   bit, that the first two chunks (first 64 keys) agree with the same run
   on the CPU, and that a sparse run computed fewer units than it was
   given (from the runner's own ``runner.*`` metrics, or the ``sparse.*``
   counters of the one-shot path), except where every unit is dirty by
   design, where every chunk must have picked the full-capacity bucket.
   In phases 3-7 the launch counts are set to 0 just before each timed
   main-path call and read just after it; the warm-up call before it and
   the ``torch.profiler`` run after it (one partition, batch or chunk:
   device busy time, idle share, top kernels) are outside.
8. One JSON line with every kernel's launches on the main path (the sum
   of those windows), its error against its plain version, its times and
   its bound.  ``fused_trend`` has no caller on any path (nor in the
   reference), so its launches are 0; phase 2 holds it against its plain
   version.
9. The last line: ``{"ok": true, "device": {...}}``.

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
RUN_SEG, RUN_SPC, RUN_CHUNKS = 512, 256, 128     # single-stream runner
RK_KEYS, RK_SEG, RK_SPC, RK_CHUNKS = 16384, 64, 2, 16   # keyed runner
ONE_SHOT_TICKS = 1 << 20
CMP_CHUNKS = 2
FRAUD_WINDOW = 64


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


def seg_dirty_torch(x, m, geom, n_segs: int):
    """The shortest torch composition of ``seg_dirty`` for one value row
    and its validity (the yardstick beside the kernel): adjacent-tick
    diffs, padded so every segment's range is one ``unfold`` window, any
    over the window."""
    import torch
    import torch.nn.functional as F
    a0, step, width = geom
    T = x.shape[-1]
    d = ((x[..., 1:] != x[..., :-1])
         | (m[..., 1:] != m[..., :-1])).to(torch.uint8)   # d[j]: tick j+1
    lo = a0 - 1                       # d index of the first tick in range
    pad_l = max(0, -lo)
    span = (n_segs - 1) * step + width
    pad_r = max(0, lo + span - (T - 1))
    dp = F.pad(d, (pad_l, pad_r))
    start = lo + pad_l
    win = dp[..., start:start + span].unfold(-1, width, step)
    return win.amax(dim=-1) > 0


def seg_dirty_bytes(rows, geom, n_segs: int, T: int) -> float:
    """Bytes ``seg_dirty`` must read for this data, each once: the union
    over units of the ticks from a unit's first tick (and its diff
    partner) to its first change, or to its last tick when clean (a warp
    stops at the first change), over all rows; plus one byte written per
    unit."""
    import torch
    a0, step, width = geom
    dev = rows[0].device
    K = rows[0].shape[0]
    d = torch.zeros((K, T), dtype=torch.bool, device=dev)   # d[t]: tick t
    for x in rows:
        d[:, 1:] |= x[:, 1:] != x[:, :-1]
    k = torch.arange(n_segs, device=dev)
    first = torch.clamp(a0 + k * step, min=1)
    last = torch.clamp(a0 + k * step + width - 1, max=T - 1)
    idx = torch.arange(T, device=dev)
    nxt = torch.where(d, idx, T).flip(-1).cummin(-1).values.flip(-1)
    f = nxt[:, torch.clamp(first, max=T - 1)]               # (K, n_segs)
    end = torch.minimum(f, last[None, :])
    live = first <= last
    mark = torch.zeros((K, T + 1), dtype=torch.int32, device=dev)
    one = torch.ones((K, n_segs), dtype=torch.int32, device=dev) * live
    mark.scatter_add_(1, (first - 1).clamp(0, T).expand(K, -1), one)
    mark.scatter_add_(1, (end + 1).clamp(0, T), -one)
    ticks = int((mark.cumsum(-1)[:, :T] > 0).sum())
    per_tick = sum(x.element_size() for x in rows)
    return float(ticks * per_tick + K * n_segs)


def check_change_kernels(dev, errs: dict, rows: dict):
    """Phase 2 for the sparse path's ``seg_dirty`` and the uncalled
    ``fused_trend``: held against their plain versions at edge shapes and
    at the main path's shapes, then timed there."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import compile as qc
    from repro_torch.core.plan import seg_range_affine
    from repro_torch.data import streams
    from repro_torch.kernels import fused_query as fq, ref
    from repro_torch.kernels import sparse_compact as sc

    gen = torch.Generator(device="cpu").manual_seed(1)
    errs["seg_dirty"] = 0.0
    # edges: NaN and -0.0, bool and int32 rows, ranges off both ends,
    # single-pair windows, more rows than one launch takes
    x = torch.zeros(3, 2, 300)
    x[0, 0, 40:50] = -0.0
    x[1, 1, 100:104] = float("nan")
    x[2] = torch.randint(0, 3, (2, 300), generator=gen).float()
    cases = [([x], (-31, 32, 64), 9), ([x.int()], (7, 48, 17), 6),
             ([x > 0.5, x], (-8, 8, 1), 36), ([x], (-5, 16, 400), 4),
             ([torch.randint(0, 2, (2, 40, 300), generator=gen).float()],
              (0, 64, 70), 4)]
    for mats, geom, n_segs in cases:
        got = sc.seg_dirty([m.to(dev) for m in mats], [geom] * len(mats),
                           n_segs)
        want = ref.seg_dirty_fused_ref(mats, [geom] * len(mats), n_segs)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"seg_dirty {geom}: kernel != plain")

    # the main path's shapes: the fraud query's lineage over the runner's
    # chunk buffer (halo + chunk), single stream and keyed
    for label, (K, seg, spc, rate) in (
            ("single", (1, RUN_SEG, RUN_SPC, 0.01)),
            ("keyed", (RK_KEYS, RK_SEG, RK_SPC, 0.01))):
        exe = qc.compile_query(streams.fraud_query(FRAUD_WINDOW).node,
                               out_len=seg, sparse=True)
        spec, sp = exe.input_specs["in"], exe.change_plan.specs["in"]
        geom = seg_range_affine(sp.lookback, sp.lookahead, 1,
                                -spec.left_halo, 0, 1, seg)
        T = spec.left_halo + seg * spc
        vals = (streams.burst_stream(T, rate, 2)[None] if K == 1 else
                streams.keyed_activity(K, T, rate, 2))
        v = torch.from_numpy(vals).to(dev)
        m = torch.ones_like(v, dtype=torch.bool)
        m[:, ::997] = False
        mats = sc.grid_mats(v, m)
        geoms = [geom] * len(mats)
        got = sc.seg_dirty(mats, geoms, spc)
        plain = ref.seg_dirty_fused_ref(mats, geoms, spc)
        lib = seg_dirty_torch(v, m, geom, spc)
        if not (torch.equal(got, plain) and torch.equal(lib, plain)):
            raise AssertionError(f"seg_dirty {label}: kernel, plain and "
                                 "torch composition disagree")
        t = {"ms": cuda_ms(lambda: sc.seg_dirty(mats, geoms, spc)),
             "plain_ms": cuda_ms(lambda: ref.seg_dirty_fused_ref(
                 mats, geoms, spc)),
             "library_ms": cuda_ms(lambda: seg_dirty_torch(v, m, geom,
                                                           spc))}
        b, by = bound(seg_dirty_bytes([v, m], geom, spc, T),
                      2.0 * K * T)
        rows[("seg_dirty", label)] = dict(
            t, max_abs_err=0.0, bound_ms=b, bound_by=by, shape=[K, 2, T],
            n_segs=spc, dirty_frac=float(got.float().mean()))
        log(f"seg_dirty {label} ({K}, 2, {T}) n_segs={spc}: "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch "
            f"composition {t['library_ms']:.4f} ms; bound {b:.4f} ms "
            f"({by}); dirty {float(got.float().mean()):.3f}")
    log(f"seg_dirty: {len(cases)} edge cases and the main path's shapes "
        "equal the plain version")

    errs["fused_trend"] = 0.0

    def f64_trend(x, w1, w2):
        p = torch.cumsum(x.double(), 0)
        pos = torch.arange(x.shape[0], device=x.device)
        return sum(s * (p - ref.shift_right(p, w, 0.0))
                   / torch.clamp(pos + 1, max=w)
                   for s, w in ((1, w1), (-1, w2)))

    for T, w1, w2 in ((N_TICKS, 20, 50), (49, 20, 50), (1001, 20, 50),
                      (100_003, 7, 64), (300_007, 30, 2000),
                      (50_000, 100, 5000)):
        x = (100.0 + torch.cumsum(torch.randn(T, generator=gen) * 0.05,
                                  0)).float().to(dev)
        diff, up = fq.fused_trend(x, w1, w2)
        pd, _ = ref.fused_trend_block_ref(x, w1, w2)
        e = sum_check(f"fused_trend T={T} w={w1},{w2}", diff, pd,
                      f64_trend(x, w1, w2),
                      scale=float(x.abs().max()) * w2)
        if not torch.equal(up, diff > 0):
            raise AssertionError("fused_trend: uptrend != diff > 0")
        errs["fused_trend"] = max(errs["fused_trend"], e)
    # timed at the trend app's 2**24 ticks; the torch composition is one
    # conv1d with both (zero-padded) box filters, then the divisions
    T, w1, w2 = N_TICKS, 20, 50
    x = (100.0 + torch.cumsum(torch.randn(T, generator=gen) * 0.05,
                              0)).float().to(dev)
    filt = torch.zeros(2, 1, w2, device=dev)
    filt[0, 0, w2 - w1:] = 1.0
    filt[1, 0, :] = 1.0
    pos = torch.arange(T, device=dev)
    cnt = torch.stack([torch.clamp(pos + 1, max=w1),
                       torch.clamp(pos + 1, max=w2)]).float()

    def composed():
        s = F.conv1d(F.pad(x, (w2 - 1, 0))[None, None], filt)[0] / cnt
        d = s[0] - s[1]
        return d, d > 0

    lib_d, _ = composed()       # a yardstick: its error is only logged
    lib_err = max_err(lib_d, f64_trend(x, w1, w2))
    t = {"ms": cuda_ms(lambda: fq.fused_trend(x, w1, w2)),
         "plain_ms": cuda_ms(lambda: ref.fused_trend_block_ref(x, w1, w2)),
         "library_ms": cuda_ms(composed)}
    b, by = bound(9.0 * T, 10.0 * T)
    rows[("fused_trend", "single")] = dict(
        t, max_abs_err=errs["fused_trend"], bound_ms=b, bound_by=by,
        shape=[T], windows=[w1, w2])
    log(f"fused_trend (2**24,) w=20,50: {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, conv1d composition "
        f"{t['library_ms']:.4f} ms (its error vs f64 {lib_err:.3g}); bound "
        f"{b:.4f} ms ({by}); max err vs plain {errs['fused_trend']:.3g}")


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


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from repro_torch.kernels import fused_query, sparse_compact
    from repro_torch.kernels import window_reduce as wr
    return {**wr.launches, **sparse_compact.launches,
            **fused_query.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels import fused_query, sparse_compact
    from repro_torch.kernels import window_reduce as wr
    for mod in (wr, sparse_compact, fused_query):
        mod.reset_launches()


def drive(main_launches: dict, fn):
    """One call on the main path: every launch count is set to 0 just
    before it and read just after, once the card has finished, and added
    to ``main_launches``.  Returns the call's result and seconds."""
    import torch
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k, n in launch_counts().items():
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
# phases 5-7: the chunked runner and the one-shot sparse path
# ---------------------------------------------------------------------------

def _grid(vals, device):
    """A grid of ``vals`` (``(T,)`` or ``(K, T)``), every tick valid."""
    from repro_torch.engine import keyed_grid
    return keyed_grid(vals, np.ones(vals.shape, bool), device=device)


def _chunk(grids: dict, c: int, n: int) -> dict:
    """Chunk ``c`` of ``n`` ticks of every grid (time on the last axis)."""
    return {k: g.replace(value=g.value[..., c * n:(c + 1) * n],
                         valid=g.valid[..., c * n:(c + 1) * n],
                         t0=g.t0 + c * n) for k, g in grids.items()}


def _same_bits(a, b) -> bool:
    """Equal validity, and equal values wherever valid."""
    import torch
    return (a.valid.shape == b.valid.shape
            and torch.equal(a.valid, b.valid)
            and torch.equal(a.value[a.valid], b.value[b.valid]))


def _head(grid, n: int, keys: int = 0):
    """The first ``n`` output ticks (of the first ``keys`` keys) on the
    host."""
    v, m = grid.value[..., :n], grid.valid[..., :n]
    if keys:
        v, m = v[:keys], m[:keys]
    return grid.replace(value=v.cpu(), valid=m.cpu())


def _compact_check(label: str, snap: dict, n_chunks: int, all_dirty: bool):
    """From the runner's own metrics: a sparse run computed fewer units
    than it was given — or, where every unit is dirty by design, every
    chunk picked the full-capacity bucket."""
    units = snap["counters"]["runner.units"]["value"]
    dirty = snap["counters"]["runner.dirty_units"]["value"]
    picks = snap["vectors"]["runner.bucket_picks"]["values"]
    if all_dirty:
        if picks[-1] != n_chunks or dirty != units:
            raise AssertionError(f"{label}: expected every chunk at full "
                                 f"capacity, picks {picks}")
    elif not (dirty < units and sum(picks[:-1]) > 0):
        raise AssertionError(f"{label}: no chunk computed fewer units than "
                             f"it was given ({dirty}/{units}, picks {picks})")
    return dirty / units


def run_runner(dev, main_launches: dict, label: str, query, grids: dict,
               cpu_grids: dict, n_keys: int, seg: int, spc: int,
               n_chunks: int, tol: str, all_dirty: bool = False) -> dict:
    """One runner phase: the same chunks through ``Runner`` at
    ``body="dense"`` and ``body="sparse"``, each timed over ``n_chunks``
    chunks on the card; sparse ≡ dense bit for bit; the first
    ``CMP_CHUNKS`` chunks (first ``CMP_KEYS`` keys) against the same
    runner on the CPU."""
    from repro_torch.core import compile as qc
    from repro_torch.engine import ExecPolicy, Runner
    keys = "vmapped" if n_keys > 1 else "single"
    kw = dict(n_keys=n_keys if n_keys > 1 else None, segs_per_chunk=spc)
    span = seg * spc
    events = n_keys * span * n_chunks
    out, res = {}, {}
    for body in ("dense", "sparse"):
        exe = qc.compile_query(query, out_len=seg, sparse=body == "sparse")
        policy = ExecPolicy(body=body, keys=keys)
        Runner(exe, policy, **kw).run(grids, 2)   # first use of every step
        r = Runner(exe, policy, **kw)
        launches = {}
        res[body], dt = drive(launches,
                              lambda: r.run(grids, n_chunks))
        for k, n in launches.items():
            main_launches[k] = main_launches.get(k, 0) + n
        snap = r.metrics.snapshot()
        rp = Runner(exe, policy, **kw)
        rp.step(_chunk(grids, 0, span))
        rp.step(_chunk(grids, 1, span))
        prof = device_profile(lambda: rp.step(_chunk(grids, 2, span)),
                              dt / n_chunks)
        cpu_kw = dict(kw, n_keys=CMP_KEYS) if n_keys > 1 else kw
        cpu = Runner(exe, policy, **cpu_kw).run(cpu_grids, CMP_CHUNKS)
        n_cmp = CMP_CHUNKS * span
        stats = compare(tol, _head(res[body], n_cmp, CMP_KEYS if n_keys > 1
                                   else 0), cpu)
        row = dict(stats, events_per_s=events / dt, seconds=dt,
                   ms_per_chunk=dt / n_chunks * 1e3, profile=prof,
                   launches_per_chunk={k: n / n_chunks
                                       for k, n in launches.items()},
                   metrics=snap)
        if body == "sparse":
            row["dirty_fraction"] = _compact_check(f"{label} sparse", snap,
                                                   n_chunks, all_dirty)
        out[body] = row
        per = ", ".join(f"{k} {n / n_chunks:g}" for k, n in launches.items()
                        if n)
        dirty = (f", dirty fraction {row['dirty_fraction']:.4f}"
                 if body == "sparse" else "")
        log(f"runner {label} {body:6s}: {events / dt:.4g} events/s, "
            f"{dt / n_chunks * 1e3:.3f} ms per chunk{dirty}; launches per "
            f"chunk: {per}; vs cpu max diff {stats['max_abs_diff']:.3g}, "
            f"{stats['flips']} gate flips")
        log(f"  one chunk: {_profile_text(prof)}")
    if not _same_bits(res["dense"], res["sparse"]):
        raise AssertionError(f"runner {label}: sparse != dense")
    log(f"runner {label}: sparse output equals dense output bit for bit")
    return out


def run_runners(dev, main_launches: dict) -> dict:
    """Phases 5 and 6."""
    from repro_torch.data import apps as A
    from repro_torch.data import streams
    out = {}
    n = RUN_SEG * RUN_SPC * RUN_CHUNKS
    vals = streams.burst_stream(n, 0.01, 0)
    ncmp = RUN_SEG * RUN_SPC * CMP_CHUNKS
    grids = {"in": _grid(vals, dev)}
    cpu = {"in": _grid(vals[:ncmp], "cpu")}
    out["fraud_single"] = run_runner(
        dev, main_launches, "fraud 2**24", streams.fraud_query(
            FRAUD_WINDOW).node, grids, cpu, 1, RUN_SEG, RUN_SPC, RUN_CHUNKS,
        "fraud")
    del grids
    app = A.make_app("trend")
    data = app.make_input(n, 0)
    few = {k: {"value": d["value"][:ncmp], "valid": d["valid"][:ncmp]}
           for k, d in data.items()}
    out["trend_single"] = run_runner(
        dev, main_launches, "trend 2**24", app.query.node,
        A.make_grids(data, device=dev), A.make_grids(few, device="cpu"), 1,
        RUN_SEG, RUN_SPC, RUN_CHUNKS, "trend", all_dirty=True)
    T = RK_SEG * RK_SPC * RK_CHUNKS
    kcmp = RK_SEG * RK_SPC * CMP_CHUNKS
    for rate in (0.01, 1.0):
        vals = streams.keyed_activity(RK_KEYS, T, rate, 0)
        grids = {"in": _grid(vals, dev)}
        cpu = {"in": _grid(vals[:CMP_KEYS, :kcmp], "cpu")}
        out[f"fraud_keyed_{rate:g}"] = run_runner(
            dev, main_launches, f"keyed fraud {RK_KEYS} keys, {rate:.0%} "
            "active", streams.fraud_query(FRAUD_WINDOW, keyed=True).node,
            grids, cpu, RK_KEYS, RK_SEG, RK_SPC, RK_CHUNKS, "fraud",
            all_dirty=rate >= 1.0)
        del grids
    return out


def run_one_shot(dev, main_launches: dict) -> dict:
    """Phase 7: ``sparse_run`` against ``partition_run``."""
    from repro_torch import obs
    from repro_torch.core import compile as qc
    from repro_torch.core.parallel import partition_run
    from repro_torch.core.sparse import sparse_run
    from repro_torch.data import streams
    n, seg = ONE_SHOT_TICKS, RUN_SEG
    n_parts = n // seg
    exe = qc.compile_query(streams.fraud_query(FRAUD_WINDOW).node,
                           out_len=seg, sparse=True)
    grids = streams.burst_grids(n, 0.01, 0, device=dev)
    sparse_run(exe, grids, 0, n_parts)           # first use of every shape
    partition_run(exe, grids, 0, 1)
    reg = obs.default()
    s0 = reg.snapshot()
    got, dt = drive(main_launches, lambda: sparse_run(exe, grids, 0,
                                                      n_parts))
    s1 = reg.snapshot()
    want, dt_d = drive(main_launches, lambda: partition_run(exe, grids, 0,
                                                            n_parts))
    if not _same_bits(got, want):
        raise AssertionError("sparse_run != partition_run")
    segs = obs.counter_delta(s0, s1, "sparse.segments")
    dirty = obs.counter_delta(s0, s1, "sparse.dirty_segments")
    if not dirty < segs:
        raise AssertionError(f"sparse_run computed {dirty} of {segs}")
    cmp_n = 8 * seg
    cpu = sparse_run(exe, {"in": _grid(streams.burst_stream(n, 0.01, 0)
                                       [:cmp_n], "cpu")}, 0, 8)
    stats = compare("fraud", _head(got, CMP_CHUNKS * seg),
                    _head(cpu, CMP_CHUNKS * seg))
    prof = device_profile(lambda: sparse_run(exe, grids, 0, n_parts), dt)
    log(f"sparse_run 2**20: {n / dt:.4g} events/s ({dt * 1e3:.2f} ms, "
        f"{dirty}/{segs} segments computed) against partition_run "
        f"{n / dt_d:.4g} events/s ({dt_d * 1e3:.2f} ms): equal bit for bit;"
        f" vs cpu max diff {stats['max_abs_diff']:.3g}")
    log(f"  one call: {_profile_text(prof)}")
    return dict(stats, events_per_s=n / dt, seconds=dt,
                dense_events_per_s=n / dt_d, dense_seconds=dt_d,
                dirty_fraction=dirty / segs, profile=prof)


# ---------------------------------------------------------------------------

KERNELS = {
    "prefix_scan": ("src/repro_torch/kernels/csrc/window_reduce.cu",
                    "src/repro/kernels/window_reduce.py:78"),
    "sliding_assoc": ("src/repro_torch/kernels/csrc/window_reduce.cu",
                      "src/repro/kernels/window_reduce.py:127"),
    "seg_dirty": ("src/repro_torch/kernels/csrc/sparse_compact.cu",
                  "src/repro/kernels/sparse_compact.py:118"),
    "fused_trend": ("src/repro_torch/kernels/csrc/fused_query.cu",
                    "src/repro/kernels/fused_query.py:76"),
}
OFF_PATH = ("fused_trend",)     # no caller in either package


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
    check_change_kernels(dev, errs, rows)

    single, keyed_launches, runner_launches, one_shot_launches = {}, {}, {}, {}
    apps = run_apps(dev, single, N_TICKS, PART, N_CMP_PARTS)
    for k in wr.launches:
        if single.get(k, 0) == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    keyed = run_keyed(dev, keyed_launches, KEYS, KEY_TICKS, CMP_KEYS)
    runners = run_runners(dev, runner_launches)
    one_shot = run_one_shot(dev, one_shot_launches)
    windows = {"partition_run": single, "batch_run": keyed_launches,
               "runner": runner_launches, "sparse_run": one_shot_launches}
    launches = {k: sum(w.get(k, 0) for w in windows.values())
                for k in KERNELS}
    for k in ("seg_dirty",):
        if not (runner_launches.get(k, 0) and one_shot_launches.get(k, 0)):
            raise AssertionError(f"{k} was never launched on the sparse "
                                 "runner or sparse_run path")
    for k in OFF_PATH:
        if launches[k]:
            raise AssertionError(f"{k} has no caller, yet launched")
    log("main-path launches: " + ", ".join(
        f"{w} {c}" for w, c in windows.items()) + f"; total {launches}")

    Path("out").mkdir(exist_ok=True)
    detail = {"card": card, "apps": apps, "keyed": keyed,
              "runner": runners, "sparse_run": one_shot,
              "kernels": {f"{k}/{lab}": v for (k, lab), v in rows.items()},
              "launches": dict(windows, total=launches)}
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
