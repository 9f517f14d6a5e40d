#!/usr/bin/env python3
"""Drive the PyTorch port's TiLT query path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):

1. Print the card's name and power limit, build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, at the
   apps' windows, at edge shapes and at the main path's shapes; time the
   kernel, the plain version and one PyTorch library call that computes
   the same function (CUDA events, median of repeats), and give its device
   time (``torch.profiler``) and its wrapper's host time per call (1000
   calls, no synchronize inside) beside the event time; ``seg_dirty`` the
   host cost of each part of a launch.  ``seg_dirty`` is held on every
   dtype a grid carries (f32, f16, bf16, f64, int64, int32, int16, int8,
   uint8, bool) with its NaN and -0.0 edges.  ``prefix_scan`` and
   ``fused_trend`` are swept over their launch plans' edges (odd T, rows
   off the 16-byte grid, block and tile boundaries, bf16 for
   ``prefix_scan``), and ``prefix_scan``'s bits are checked to repeat over
   20 calls and to be a row's own (alone, among others, gathered).  The
   ``sliding_assoc`` shapes of the runners (recorded from the wrapper
   during the first-use run of each dense runner of phases 5-6, the same
   chunks as the timed run) are timed after phase 7, with their launches
   per timed run.
3. The main path, single stream: every app of ``repro_torch.data.apps``
   through ``compile_query`` -> ``partition_run`` over 2**24 ticks held on
   the card, in 16 partitions of 2**20 ticks; ysb once more with the
   subtract-on-evict sum.  The first two partitions are compared with the
   same query run on the CPU (plain versions) at identical partitioning.
   ``partition_run`` is staged: one captured graph replayed per partition
   (``engine.capture.Staged``, captured at the first use of the shape).
   Beside it, outside the launch-count windows, the same call compiled
   with ``jit=False`` (eager): both timed in turns, each one's device busy
   time and idle share, its synchronizing calls (the staged one must make
   none) and the staged one's replays (one per partition); then both over
   the app's inputs floored to integers, which must agree bit for bit.
4. The main path, keyed: trend, fraud and ysb through ``batch_run`` at 4096
   keys x 4096 ticks, the first 64 keys compared with the CPU; staged (one
   replay) against ``jit=False`` as in phase 3.
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
   stream at 1%, 512-tick segments, against ``partition_run``; staged
   against ``jit=False`` as in phase 3, fused (one switched graph whose
   bucket is picked on the card: no synchronizing call) and three-phase
   (its mask eager, the count read on the host, one graph).
   Phases 5-7 check that the sparse output equals the dense one bit for
   bit, that the first two chunks (first 64 keys) agree with the same run
   on the CPU, and that a sparse run computed fewer units than it was
   given (from the runner's own ``runner.*`` metrics, or the ``sparse.*``
   counters of the one-shot path), except where every unit is dirty by
   design, where every chunk must have picked the full-capacity bucket.
   In phases 3-11 the launch counts are set to 0 just before each timed
   main-path call and read just after it; the warm-up call before it and
   the ``torch.profiler`` run after it (one partition, batch or chunk:
   device busy time, idle share, top kernels) are outside.  From phase 5
   on every chunk is a replay of a captured CUDA graph (the sparse one
   picks its bucket on the device); a replay adds the launches its capture
   recorded, so the windows count the same launches as eager steps did.
   Each timed runner, session and ingestion runner has its steps captured
   ahead in a window of its own (``serve.aot_capture``, as a served runner
   is prepared), so its timed run excludes the first use of each step.
   A steady chunk of every runner and session cell must make no
   synchronizing call (PyTorch's sync debug mode).  For each sparse
   runner and session one replay of its switched graph, then its parts
   one by one, are profiled (``replay_check``), to see whether the
   profiler's busy time holds the kernels of the conditional body.
8. Multi-query sharing: the 16 ``dashboard_queries`` in one
   ``MultiQuerySession`` — unkeyed over ``dashboard_input``'s 2**24 ticks
   in 256 chunks of 65536 (dense), keyed over ``dashboard_keyed_input``'s
   4096 symbols x 16384 ticks in chunks of 1024 (dense and sparse, at 100%
   and at 1% active keys, the inactive keys holding their first price).
   Sparse ≡ dense bit for bit at both rates; the session ≡ 16 solo
   runners over the same chunks, every head bit for bit (same kernels,
   same buffers); the first two chunks (64 keys, half of them active ones
   at 1%) against the CPU: the trend heads within ``tolerance``'s
   ``dashboard`` limits, the stddev heads of the random walks only for
   finite values and momentum's validity (f32 cancellation, see
   ``tolerance.py``).  Each cell runs again, untimed, at its shapes over
   integer prices in [0, 16), where every head, the stddev ones included,
   is held against the CPU within ``MQ_STD_TOL``.  Events/s over the 16
   queries, ms per chunk, device busy time and idle share of one steady
   chunk, its host reads, the sharing report and the launches per chunk
   are printed.
9. Out-of-order ingestion with revision: ``fig_ooo``'s query (the
   window(32) mean minus the window(64) mean), 128-tick segments, 8 per
   chunk, its 2**17-tick burst stream, late fractions 0.02 and 0.1 at
   lateness 16 and 256, through ``IngestRunner(..., policy="revise")``
   with a 3-chunk horizon; then keyed, 64 keys x 8192 ticks.  After
   ``flush()`` the sealed outputs with every correction laid over them
   must equal an in-order ``Runner`` over the same events bit for bit.
10. Serving (``repro_torch.serve``), the steady state of every cell under
   PyTorch's sync debug mode set to raise and with no graph captured after
   warm-up: ``fig_latency``'s fraud query at per-call batches 1, 10, 100
   and 1000 ticks (p50 and p99 per blocked call); cold and warm first
   result, two fresh processes (``chip_smoke.py --first-result DIR``) over
   one empty cache directory; keyed fraud served at phase 6's width
   (16384 keys, sparse, 1% and 100% active), equal to ``Runner.run`` bit
   for bit; the event path over phase 9's setup through the admission
   ring, sealed chunks plus corrections equal to in-order execution.
   Each cell's ``sliding_assoc`` shapes and ``seg_dirty`` geometries,
   recorded from the wrappers while the service warms up (and captures
   every step), are held against their plain versions; the served
   latency results against the same requests served on the CPU.
11. Mesh placement (``torch.distributed``) on the 1-rank NCCL mesh that
   ``launch.mesh.make_local_mesh()`` starts on the card (NCCL refuses two
   ranks on one card, so the multi-rank exchange is not exercised here):
   ``shard_map_run`` of the trend app and the fraud query (and the fraud
   query with the subtract-on-evict sum) over 2**24 ticks, dense and
   sparse, against ``partition_run(..., n_parts=1)``; ``shard_union_run``
   of phase 8's 16 dashboard queries over 2**24 ticks against the session;
   both staged (one replay a call and no synchronizing call: the
   exchange, the body, the NCCL gather; the sparse step picks its body on
   the card), ``shard_map_run`` held bit for bit against, and timed
   beside, ``jit=False`` as in phase 3;
   ``Runner(placement=mesh_placement(mesh))`` in phase 6's keyed fraud
   cells (16384 keys, 1% and 100% active, dense and sparse) and phase 5's
   single-stream fraud sparse cell, against the local runner over the same
   chunks, with no synchronizing call in a steady chunk and no capture
   after warm-up; ``KeyedEngine(mesh=)`` at phase 6's width and phase 8's
   keyed session (1% active, sparse) with ``mesh=``, both on integer
   prices.  Every mesh result must equal its local counterpart bit for
   bit; the inputs are phases 5-8's, made again from their seeds.  Both
   sides run the same kernels at the same shapes, so every shape the
   phase calls ``sliding_assoc``, ``seg_dirty`` and ``prefix_scan`` at
   (recorded from the wrappers through every warm-up, capture and
   launch-count window of the phase) is also held against the kernel's
   plain version.  Each cell prints its ms per call or chunk beside the
   local one's (an untimed mesh call in the launch-count window, then
   local, mesh, mesh, local timed in turns), their difference, and the
   runners' device busy time and idle share of one steady chunk; the
   phase prints
   its launches of ``sliding_assoc``, ``seg_dirty`` and ``prefix_scan``,
   the NCCL version and the device count.
12. The static audit (``repro_torch.analysis``) on the card, on phase
   11's 1-rank NCCL group: (a) all 16 points of the ExecPolicy lattice
   (the ``(policy, pass)`` summary, the verdict and the wall time per
   point; no error finding, warnings printed with their provenance); (b)
   the known-bad corpus of ``tests/test_torch_analysis.py``, each fixture
   firing its code on the card and the shipped runner at its point
   staying clean; (c) every runner cell of phases 5, 6, 8, 9, 10 and 11,
   audited once after its timed run, outside its timed and launch-count
   windows (``audit=<verdict>`` beside the cell's numbers; an error
   finding fails the script); (d) every ``sliding_assoc``, ``seg_dirty``
   and ``prefix_scan`` shape the audits launched, held against the plain
   versions.  The group is destroyed after it.
13. LM serving (``repro_torch.launch.serve``; no kernel of the TiLT path
   lies on it, so its launch-count window must read 0): (a) qwen3-1.7b at
   full width and depth, weights drawn on the card from a seeded
   ``torch.Generator``, 64 requests of 1024 seeded token ids served in
   waves of 32, 128 tokens each, through ``serve_waves`` (one warm-up
   wave first, which captures the decode graph): tokens/s, prefill ms per
   wave and decode ms per step (p50, p99; CUDA events), then a steady
   decode step alone: its synchronizing calls (0, and none under the sync
   debug mode set to raise), its device busy time, idle share and top
   kernels (``torch.profiler``) and its memory bound (every weight and
   cache buffer read once over 3.35 TB/s); prefill/decode consistency on
   two requests (teacher-forced decode against a full forward of each
   request alone: max|d| / max|logit| <= 2e-2).  (b) gemma2-2b (one
   (local, global) period, prompt 5120), granite-moe-1b-a400m (2 layers,
   prompt 1024: the served prefill drops picks at capacity; its
   consistency check runs dropless groups), recurrentgemma-9b (one period,
   prompt 3072), rwkv6-7b (2 layers, prompt 64) and whisper-large-v3 (2 + 2
   layers, 1500 frames), each at full width in batches of 4, with the same
   numbers and check.  (c) every SMOKE configuration, in its dtype and at
   f32 (TF32 off for matmuls and cuDNN), and qwen3's f8 cache, on the card
   and on the CPU with the same weights: forward, prefill, 8 decode steps
   (graph replays on the card) and the caches, bf16 within 2e-2 of the
   largest value, f32 within 1e-4.  Every serving cell also holds step
   t's logits across step t+1 (a decode step returns a copy).
14. LM training (``repro_torch.train``, ``repro_torch.launch.train``; its
   launch-count window must read 0 too): (a) qwen3-1.7b at full width and
   depth, remat on, weights drawn on the card from a seeded
   ``torch.Generator``, the reference's default ``AdamWConfig``, batch 8 x
   seq 1024 from ``TokenPipeline``: step 1 eager (and the capture), then
   20 timed replays (ms a step p50/p99 by CUDA events, tokens/s), a steady
   step alone (0 synchronizing calls, none under the sync debug mode set
   to raise; device busy time, idle share and top kernels by
   ``torch.profiler``), the graph's private pool, the peak allocated
   memory, every step's loss (finite), and the compute bound (model FLOPs
   6*N*T plus attention over 989 TFLOP/s bf16) and the share of it
   reached.  (b) qwen3-1.7b at full width with 2 layers: four captured
   steps against four eager steps from one state, losses, parameters and
   moments bit for bit.  (c) every SMOKE configuration and its f32
   variant, the loss and gradients on the card against the CPU (TF32
   off; f32: loss 1e-5 relative, a gradient leaf 1e-4 of its largest
   magnitude, or 3x the leaf's sensitivity to one ulp of the weights where
   that is larger; bf16: 1e-3 and 5e-2) and three train steps' losses;
   the f32 variant also run in f64 on both (every f32 op promoted): card
   and CPU within 1e-10, and each one's f32 gradients held against that
   f64 result.  (d)
   ``launch.train.main`` at SMOKE (on its 1-rank NCCL mesh) with
   checkpoints under ``out/``, cut
   after step 3's checkpoint and relaunched, ends bit for bit with the
   uninterrupted run; a checkpoint restored into a live captured step
   continues it bit for bit.
15. Sharding and the dry-run (``repro_torch.launch.dryrun``, its launch-
   count window must read 0 too): (a) five cells of ``python -m
   repro_torch.launch.dryrun --mesh single`` (a fake process group of 256
   ranks as the (16, 16) mesh, fake tensors laid out as DTensors, one
   eager step traced), each in its own process, all started before phase
   14 (they use the host's CPU, not the card) and read here:
   qwen3-1.7b at train_4k, prefill_32k and decode_32k, granite-moe-1b-
   a400m and dbrx-132b at train_4k; each must be ``ok``, and prints its
   GB a device against 80 GB, its dominant roofline term and its roofline
   fraction on the H100's constants; each must have traced CUDA tensors
   over a CUDA mesh (``device_type`` ``cuda``).  (b) The same at 14(a)'s
   cell on ``--mesh local`` (a (1, 1) mesh over a real 1-rank NCCL
   group), also ``cuda``: its
   argument bytes equal the real parameters, AdamW state and batch
   exactly, and its FLOPs ``FlopCounterMode``'s over one real eager step;
   its predicted peak beside 14(a)'s ``max_memory_allocated``, its terms
   beside 14(a)'s ms a step and bound.  (c) 14(d)'s ``launch.train.main``
   runs (a 1-rank NCCL mesh, ``DTensor`` parameters), uninterrupted and
   cut at step 3 and relaunched, equal a plain ``make_train_step`` loop
   over plain tensors with the same seeds and settings bit for bit; a
   mesh train step's graphs and the syncs of a steady step.
16. The examples (``examples_torch/``, from a temporary working
   directory, removed after): (a) each at its shipped size on the card
   through its ``main`` with no ``--device``, in the phase's launch-count
   window (``sliding_assoc`` and ``seg_dirty`` must each launch in it;
   no example reaches ``prefix_scan``): ``serving_loop`` twice on one fresh cache directory
   (``plan=cold`` then ``plan=warm``, its steady tail under
   ``set_sync_debug_mode("error")``), ``train_lm --full-100m --steps
   100`` with its checkpoints in the temporary directory (losses finite,
   the last below the first), ``late_data``'s bit-identity,
   ``plan_audit`` clean then an error, ``metrics_observability``'s schema
   and no retraces, ``serve_lm``'s 8 requests and 128 tokens, the
   dashboard's breakout and momentum heads bit for bit against solo
   runners; (b) each TiLT example on the card against the CPU at the CPU
   tests' sizes, under their rules (``tests/torch_examples_common.py``:
   exact figures, outputs within ``tolerance``); (c) ``python
   examples_torch/quickstart.py`` as a subprocess exits 0 on the card.
17. One JSON line with every kernel's launches on the main path (the sum
   of the windows of phases 3-11 and 13-16), its error against its plain
   version, its times and its bound.  ``fused_trend`` has no caller on any
   path (nor in the reference), so its launches are 0; phase 2 holds it
   against its plain version.
18. The last line: ``{"ok": true, "device": {...}}``.

Every phase prints its wall seconds and the card's SM clock, temperature
and power draw after it (``nvidia-smi``).

Without a CUDA device it exits with code 2 before printing any result.
"""
from __future__ import annotations

import json
import os
import re
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
MQ_QUERIES = 16                                          # phase 8
MQ_TICKS, MQ_SPAN = 1 << 24, 65536
MQ_KEYS, MQ_KEY_TICKS, MQ_KEY_SPAN = 4096, 16384, 1024
MQ_STD_TOL = 1e-4   # every head, card against CPU, on integer prices
OOO_SEG, OOO_SPC, OOO_TICKS = 128, 8, 1 << 17             # phase 9
OOO_POLL = 256
OOO_KEYS, OOO_KEY_TICKS = 64, 8192
SERVE_BATCHES = (1, 10, 100, 1000)                       # phase 10
SERVE_EVENTS, SERVE_WARMUP, SERVE_WINDOW = 1_000_000, 2, 16
FIRST_RESULT_BATCH = 100
# phase 12(c): each audited cell's verdict, findings and seconds, and the
# kernel shapes the audits launched (held in 12(d))
AUDITS: dict = {"cells": {}, "shapes": {}}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def card_state() -> str:
    """The card's SM clock, temperature and power draw now."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    sm, temp, draw = (v.strip() for v in
                      res.stdout.strip().splitlines()[0].split(","))
    return f"sm clock {sm}, {temp} C, drawing {draw}"


PHASE_SECONDS: dict = {}


def phase(name: str, fn, *args):
    """Run one phase, print its wall seconds and the card's state after
    it, and keep the seconds for the detail file."""
    t0 = time.perf_counter()
    res = fn(*args)
    dt = time.perf_counter() - t0
    PHASE_SECONDS[name] = dt
    log(f"phase {name}: {dt:.1f} s ({card_state()})")
    return res


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


def host_ms(fn, calls: int = 1000) -> float:
    """Host time per call over ``calls`` calls with no synchronize inside
    (what a wrapper costs the host; the card catches up afterwards)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def kernel_device_ms(fn, name: str, calls: int = 20):
    """Mean device time per call of the kernels whose name contains
    ``name``, by ``torch.profiler`` over ``calls`` calls (None when the
    profiler reports no device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(us) / 1e3 / calls if us else None


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

    # prefix_scan: f32 accumulation of f32 or bf16 rows, at the plan's
    # edges (wr.prefix_plan: a block per row up to PREFIX_TILE, tiles
    # above), odd T, and rows off the 16-byte grid (a view one element
    # into its allocation)
    tile = wr.PREFIX_TILE
    shapes = [(1, 10), (3, 1025), (2, 100_003), (6, PART + 49)]
    shapes += [(3, T) for T in (1, tile - 1, tile, tile + 1, PART + 9)]
    for R, T in shapes:
        x = randn(R, T)
        for dt in (torch.float32, torch.bfloat16):
            for layout in ("contiguous", "misaligned"):
                xi = x.to(dt).contiguous()
                if layout == "misaligned":
                    xi = misaligned(xi)
                got = wr.prefix_scan(xi)
                if got.dtype != torch.float32:
                    raise AssertionError(f"prefix_scan {dt}: out "
                                         f"{got.dtype}")
                e = sum_check(f"prefix_scan {dt} {layout} ({R},{T})", got,
                              ref.prefix_sum_ref(xi.float()),
                              torch.cumsum(xi.double(), dim=-1))
                errs["prefix_scan"] = max(errs["prefix_scan"], e)
    prefix_bits_checks(dev, gen)
    # W < 8 sums through ops.sliding_sum: subtract-on-evict on prefix_scan,
    # where the prefix sums P are what is rounded and P[t] - P[t-W] what is
    # compared; the block sums on sliding_assoc, held against the plain
    # block version on the CPU
    for W in (1, 3, 7):
        x = randn(2, 50_000, scale=2.0)
        valid = (torch.rand(50_000, generator=gen) > 0.2).to(dev)
        p = torch.cumsum(torch.where(valid, x, 0.0).double(), dim=-1)
        exact = p - ref.shift_right(p, W, 0.0)
        s, n = ops.sliding_sum(x, valid, W, algo="soe")
        sr, nr = ref.sliding_sum_ref(x, valid, W)
        e = sum_check(f"ops.sliding_sum soe W={W}", s, sr, exact,
                      scale=float(p.abs().max()))
        exact_check(f"ops.sliding_sum soe W={W} count", n, nr)
        errs["prefix_scan"] = max(errs["prefix_scan"], e)
        s, n = ops.sliding_sum(x, valid, W)
        sc, nc = ops.sliding_sum(x.cpu(), valid.cpu(), W)
        e = sum_check(f"ops.sliding_sum block W={W}", s, sc.to(dev), exact)
        exact_check(f"ops.sliding_sum block W={W} count", n, nc.to(dev))
        errs["sliding_assoc"] = max(errs["sliding_assoc"], e)
    log(f"prefix_scan: f32/bf16 and W<8 subtract-on-evict sums agree with "
        f"the plain version (max err {errs['prefix_scan']:.3g}); W<8 block "
        f"sums on sliding_assoc with the CPU's")

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
        fn = lambda: wr.sliding_assoc(x, 50, "add")  # noqa: E731
        t = {
            "ms": cuda_ms(fn),
            "plain_ms": cuda_ms(lambda: ref.sliding_assoc_block_ref(
                x, 50, torch.add, 0.0)),
            # trailing 50-tick sums in one call: conv1d with a ones filter
            "library_ms": cuda_ms(lambda: F.conv1d(
                x.unsqueeze(1), ones, padding=49)),
            # every device event of the wrapper, and its host time
            "device_ms": kernel_device_ms(fn, ""),
            "host_ms": host_ms(fn),
        }
        b, by = bound(8.0 * R * T, 2.0 * R * T)
        rows[("sliding_assoc", label)] = dict(t, max_abs_err=e, bound_ms=b,
                                              bound_by=by, shape=[R, T],
                                              window=50)
        xp = F.pad(x, (49, 0), value=-float("inf"))
        tmax = cuda_ms(lambda: wr.sliding_assoc(x, 50, "max"))
        tpool = cuda_ms(lambda: F.max_pool1d(xp.unsqueeze(1), 50, stride=1))
        log(f"sliding_assoc {label} ({R},{T}) W=50: add {t['ms']:.4f} ms "
            f"event-timed, {_ms(t['device_ms'])} on the device, wrapper "
            f"{t['host_ms']:.4f} ms of host time per call; "
            f"plain {t['plain_ms']:.4f} ms, conv1d {t['library_ms']:.4f} ms;"
            f" max {tmax:.4f} ms, max_pool1d {tpool:.4f} ms; bound "
            f"{b:.4f} ms ({by})")
    for label, (R, T) in (("single", (2, PART + 9)),
                          ("keyed", (2 * KEYS, KEY_TICKS + 9))):
        x = (torch.rand(R, T, generator=gen) < 0.33).float().to(dev)
        e = sum_check(f"prefix_scan {label}", wr.prefix_scan(x),
                      ref.prefix_sum_ref(x), torch.cumsum(x.double(), -1))
        errs["prefix_scan"] = max(errs["prefix_scan"], e)
        if not torch.equal(wr.prefix_scan(x), torch.cumsum(x, dim=-1)):
            raise AssertionError(f"prefix_scan {label}: 0/1 counts differ "
                                 "from torch.cumsum")
        fn = lambda: wr.prefix_scan(x)
        t = {
            "ms": cuda_ms(fn),
            "plain_ms": cuda_ms(lambda: ref.prefix_sum_ref(x)),
            "library_ms": cuda_ms(lambda: torch.cumsum(x, dim=-1)),
            # every device event of the wrapper (the status words' memset
            # of the long regime included), and its host time
            "device_ms": kernel_device_ms(fn, ""),
            "host_ms": host_ms(fn),
        }
        b, by = bound(8.0 * R * T, 1.0 * R * T)
        plan = wr.prefix_plan(R, T)
        rows[("prefix_scan", label)] = dict(
            t, max_abs_err=e, bound_ms=b, bound_by=by, shape=[R, T],
            plan=list(plan))
        log(f"prefix_scan {label} ({R},{T}) [{plan.regime}, {plan.blocks} "
            f"blocks]: {t['ms']:.4f} ms event-timed, "
            f"{_ms(t['device_ms'])} on the device, wrapper "
            f"{t['host_ms']:.4f} ms of host time per call; plain "
            f"{t['plain_ms']:.4f} ms, cumsum {t['library_ms']:.4f} ms; "
            f"bound {b:.4f} ms ({by}); equals cumsum on 0/1 rows")
    return errs, rows


def _ms(v) -> str:
    return "not reported" if v is None else f"{v:.4f} ms"


def misaligned(x):
    """``x`` copied into a contiguous view one element into a larger
    allocation (as ``buf[1:]``), so its rows are off the 16-byte grid."""
    buf = x.new_empty(x.numel() + 1)
    v = buf[1:].view(x.shape)
    v.copy_(x)
    if v.data_ptr() % 16 == 0:
        raise AssertionError("misaligned: view is 16-byte aligned")
    return v


def prefix_bits_checks(dev, gen) -> None:
    """``prefix_scan``'s bits follow from a row's values alone: 20 calls
    agree bit for bit (the long regime's carries do not depend on the
    blocks' timing), and a row gives the same bits alone, among others and
    after a gather, short rows (200 of 4105) and long (5 of 2**20 + 9)."""
    import torch
    from repro_torch.kernels import window_reduce as wr

    def bits(a):
        return a.view(torch.int32)

    for R, T in ((2, PART + 9), (2 * KEYS, KEY_TICKS + 9), (200, 4105),
                 (5, PART + 9)):
        x = (torch.randn(R, T, generator=gen) * 5 + 100).to(dev)
        first = bits(wr.prefix_scan(x))
        for _ in range(19):
            if not torch.equal(bits(wr.prefix_scan(x)), first):
                raise AssertionError(f"prefix_scan ({R},{T}): bits differ "
                                     "between repeated calls")
        if R in (200, 5):
            row = R // 2 + 1
            alone = bits(wr.prefix_scan(x[row:row + 1].contiguous())[0])
            ids = torch.tensor([R - 1, row, 0], device=dev)
            gathered = bits(wr.prefix_scan(x[ids].contiguous())[1])
            if not (torch.equal(alone, first[row])
                    and torch.equal(alone, gathered)):
                raise AssertionError(f"prefix_scan ({R},{T}): a row's bits "
                                     "depend on its neighbours")
    log("prefix_scan: identical bits over 20 calls, and for a row alone, "
        "among others and gathered")


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
    seg_dirty_dtype_checks(dev, gen)

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
        # wrapper and kernel told apart: device time by the profiler, host
        # time of the wrapper with no synchronize inside
        t["device_ms"] = kernel_device_ms(
            lambda: sc.seg_dirty(mats, geoms, spc), "seg_dirty")
        t["host_ms"] = host_ms(lambda: sc.seg_dirty(mats, geoms, spc))
        rows[("seg_dirty", label)] = dict(
            t, max_abs_err=0.0, bound_ms=b, bound_by=by, shape=[K, 2, T],
            n_segs=spc, dirty_frac=float(got.float().mean()),
            plan=list(sc.seg_dirty_plan(K * spc, geom[2])))
        log(f"seg_dirty {label} ({K}, 2, {T}) n_segs={spc}: "
            f"{t['ms']:.4f} ms event-timed, kernel {_ms(t['device_ms'])} on "
            "the device, "
            f"wrapper {t['host_ms']:.4f} ms of host time per call; plain "
            f"{t['plain_ms']:.4f} ms, torch composition "
            f"{t['library_ms']:.4f} ms; bound {b:.4f} ms ({by}); dirty "
            f"{float(got.float().mean()):.3f}")
        if label == "single":
            rows[("seg_dirty", "host parts")] = wrapper_host_parts(
                dev, mats, geoms, spc)
    log(f"seg_dirty: {len(cases)} edge cases and the main path's shapes "
        "equal the plain version")

    errs["fused_trend"] = 0.0

    def f64_trend(x, w1, w2):
        p = torch.cumsum(x.double(), 0)
        pos = torch.arange(x.shape[0], device=x.device)
        return sum(s * (p - ref.shift_right(p, w, 0.0))
                   / torch.clamp(pos + 1, max=w)
                   for s, w in ((1, w1), (-1, w2)))

    # the apps' windows, then fq.trend_plan's block edges: T one short of
    # and past whole blocks, windows wider than a tile (one stripe a block,
    # walked in tiles), rows off the 16-byte grid
    cases = [(N_TICKS, 20, 50, False), (49, 20, 50, False),
             (1001, 20, 50, False), (100_003, 7, 64, False),
             (300_007, 30, 2000, False), (50_000, 100, 5000, False)]
    for w1, w2 in ((20, 50), (1, 2), (100, 2048), (100, 2049),
                   (1000, 5000)):
        span = fq.trend_plan(1, w2).span
        cases += [(3 * span + d, w1, w2, m) for d in (-1, 1, 3)
                  for m in (False, True)]
    for T, w1, w2, mis in cases:
        x = (100.0 + torch.cumsum(torch.randn(T, generator=gen) * 0.05,
                                  0)).float().to(dev)
        if mis:
            x = misaligned(x)
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
    fn = lambda: fq.fused_trend(x, w1, w2)
    t = {"ms": cuda_ms(fn),
         "plain_ms": cuda_ms(lambda: ref.fused_trend_block_ref(x, w1, w2)),
         "library_ms": cuda_ms(composed),
         "device_ms": kernel_device_ms(fn, "fused_trend"),
         "host_ms": host_ms(fn)}
    b, by = bound(9.0 * T, 10.0 * T)
    rows[("fused_trend", "single")] = dict(
        t, max_abs_err=errs["fused_trend"], bound_ms=b, bound_by=by,
        shape=[T], windows=[w1, w2], plan=list(fq.trend_plan(T, w2)))
    log(f"fused_trend: {len(cases)} cases agree with the plain version")
    log(f"fused_trend (2**24,) w=20,50: {t['ms']:.4f} ms event-timed, "
        f"{_ms(t['device_ms'])} on the device, wrapper {t['host_ms']:.4f} "
        f"ms of host time per call; plain "
        f"{t['plain_ms']:.4f} ms, conv1d composition "
        f"{t['library_ms']:.4f} ms (its error vs f64 {lib_err:.3g}); bound "
        f"{b:.4f} ms ({by}); max err vs plain {errs['fused_trend']:.3g}")


SEG_DIRTY_DTYPES = ("float32", "float16", "bfloat16", "float64", "int64",
                    "int32", "int16", "int8", "uint8", "bool")


def seg_dirty_dtype_checks(dev, gen) -> None:
    """``seg_dirty`` on every dtype a grid carries, read in place, against
    its plain version: warp and block units, rows on and off the vector
    grid, keyed matrices of several channels; floats with NaN (a change),
    -0.0 after 0.0 (none) and +-inf; int64 above 2**24 (f32 would merge
    2**40 and 2**40 + 1)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_compact as sc
    n = 0
    for name in SEG_DIRTY_DTYPES:
        dt = getattr(torch, name)
        for K, C, T, geom, n_segs in ((4, 3, 300, (-3, 32, 64), 8),
                                       (2, 2, 3200, (-3, 512, 577), 6),
                                       (512, 1, 193, (0, 64, 129), 2)):
            base = torch.randint(0, 50, (K, C, T), generator=gen)
            hold = torch.rand((K, C, T), generator=gen) > 0.25 / geom[2]
            hold[..., 0] = False
            idx = torch.where(hold, 0, torch.arange(T)).cummax(-1).values
            x = torch.gather(base, -1, idx)
            if dt.is_floating_point:
                x = x.to(dt)
                x[0, 0, 40:60] = 0.0
                x[0, 0, 50:60] = -0.0
                x[1 % K, -1, T // 2:T // 2 + 3] = float("nan")
                x[-1, 0, T // 3] = float("inf")
                x[-1, 0, T // 3 + 1] = -float("inf")
            elif dt == torch.int64:
                x = x + (1 << 40)
                x[-1, 0, T // 3] += 1
            else:
                x = (x > 25) if dt == torch.bool else x.to(dt)
            geoms = [geom]
            for mat in (x, x[..., 1:]):
                got = sc.seg_dirty([mat.to(dev)], geoms, n_segs)
                want = ref.seg_dirty_fused_ref([mat], geoms, n_segs)
                if not torch.equal(got.cpu(), want):
                    raise AssertionError(f"seg_dirty {name} ({K},{C},{T}): "
                                         "kernel != plain")
                n += 1
    # the value comparison's edges, one f32 and one f16 row each: -0.0
    # after 0.0 is clean, NaN after NaN is a change
    for dt in (torch.float32, torch.float16, torch.bfloat16, torch.float64):
        x = torch.zeros(1, 1, 64, dtype=dt)
        x[..., 10:20] = -0.0
        x[..., 40:44] = float("nan")
        got = sc.seg_dirty([x.to(dev)], [(0, 16, 16)], 4)
        if got.cpu().tolist() != [[False, False, True, False]]:
            raise AssertionError(f"seg_dirty {dt}: NaN/-0.0 flags "
                                 f"{got.cpu().tolist()}")
    log(f"seg_dirty: {n} cases over {len(SEG_DIRTY_DTYPES)} dtypes "
        f"({', '.join(SEG_DIRTY_DTYPES)}) and the NaN/-0.0 edges equal the "
        "plain version")


def wrapper_host_parts(dev, mats, geoms, n_segs: int) -> dict:
    """Host ms per call (1000 calls, no synchronize inside) of the parts a
    ``seg_dirty`` launch can cost the host: those of this wrapper and the
    ones the previous wrapper paid on every call (a ``torch.cuda.device``
    context, a ``Stream`` object, three ``ctypes`` arrays, the library's
    row limit by a ``ctypes`` call), and the whole wrapper."""
    import ctypes
    import torch
    from repro_torch.kernels import sparse_compact as sc
    from repro_torch.kernels.build import launch_stream, library
    dev = mats[0].device        # with its index, as the wrapper sees it
    xs = [m.reshape((-1,) + m.shape[-2:]) for m in mats]
    K = xs[0].shape[0]
    words = list(sc.pack_rows(xs))
    table = [words[i:i + 3] for i in range(0, len(words), 3)]

    def old_arrays():
        n = len(table)
        return ((ctypes.c_void_p * n)(*[r[0] for r in table]),
                (ctypes.c_longlong * n)(*[r[1] for r in table]),
                (ctypes.c_int * n)(*[r[2] for r in table]))

    def old_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    parts = {
        "this wrapper: raw stream (launch_stream)":
            lambda: launch_stream(dev),
        "this wrapper: row table (pack_rows)": lambda: sc.pack_rows(xs),
        "this wrapper: plan (seg_dirty_plan)":
            lambda: sc.seg_dirty_plan(K * n_segs, geoms[0][2]),
        "both: output (torch.empty)": lambda: torch.empty(
            (K, n_segs), dtype=torch.uint8, device=dev),
        "previous: device context + Stream object": old_stream,
        "previous: three ctypes arrays": old_arrays,
        "previous: library.load() + sd_max_rows()":
            lambda: library.load().sd_max_rows(),
        "whole wrapper (seg_dirty)":
            lambda: sc.seg_dirty(mats, geoms, n_segs),
    }
    # the C entry point itself: refused before the launch (no rows), and
    # with the launch
    lib = sc._seg_lib()
    packed = sc.pack_rows(xs)
    out = torch.zeros((K, n_segs), dtype=torch.bool, device=dev)
    a0, step, width = geoms[0]
    group, blocks = sc.seg_dirty_plan(K * n_segs, width)
    stream = launch_stream(dev)
    T = xs[0].shape[-1]

    def c_call(n_rows):
        return lambda: lib.sd_seg_dirty(
            packed, n_rows, K, n_segs, a0, step, width, T, out.data_ptr(),
            0, group, blocks, dev.index, stream)

    parts["C entry, refused before the launch"] = c_call(0)
    parts["C entry with the kernel launch"] = c_call(len(packed) // 3)
    out = {k: host_ms(fn) for k, fn in parts.items()}
    log("seg_dirty host time per call by part (ms): " + "; ".join(
        f"{k} {v:.5f}" for k, v in out.items()))
    return out


def record_shapes(fn, seen: dict = None) -> dict:
    """Every ``sliding_assoc`` shape (``[R, T, W, op, calls]``), every
    ``seg_dirty`` geometry (``[[(shape, dtype) of each row matrix],
    geoms, n_segs, calls]``) and every ``prefix_scan`` input
    (``[R, T, dtype, 16-byte aligned, calls]``) the wrappers see while
    ``fn()`` runs (their module attributes are swapped for recorders, so
    every caller is seen, a step being warmed up before its capture among
    them).  Given ``seen`` (kernel -> shape -> calls), the calls add into
    it and the result covers every call recorded there."""
    from repro_torch.kernels import sparse_compact as sc
    from repro_torch.kernels import window_reduce as wr
    seen = {} if seen is None else seen
    slid = seen.setdefault("sliding_assoc", {})
    segs = seen.setdefault("seg_dirty", {})
    pre = seen.setdefault("prefix_scan", {})
    orig_s, orig_d, orig_p = wr.sliding_assoc, sc.seg_dirty, wr.prefix_scan

    def sliding(x, window, op):
        key = (*x.shape, int(window), op)
        slid[key] = slid.get(key, 0) + 1
        return orig_s(x, window, op)

    def seg_dirty(mats, geoms, n_segs):
        key = (tuple((tuple(m.shape), m.dtype) for m in mats),
               tuple(tuple(int(v) for v in g) for g in geoms), int(n_segs))
        segs[key] = segs.get(key, 0) + 1
        return orig_d(mats, geoms, n_segs)

    def prefix(x):
        key = (*x.shape, x.dtype, x.data_ptr() % 16 == 0)
        pre[key] = pre.get(key, 0) + 1
        return orig_p(x)

    wr.sliding_assoc, sc.seg_dirty = sliding, seg_dirty
    wr.prefix_scan = prefix
    try:
        fn()
    finally:
        wr.sliding_assoc, sc.seg_dirty = orig_s, orig_d
        wr.prefix_scan = orig_p
    return {k: [[*key, n] for key, n in v.items()] for k, v in seen.items()}


def recording(seen: dict, fn):
    """``fn`` made to record its kernels' shapes into ``seen``
    (:func:`record_shapes`) each time it is called; returns ``fn()``."""
    def run():
        box = []
        record_shapes(lambda: box.append(fn()), seen)
        return box[0]
    return run


def _changes(shape, dtype, gen):
    """Piecewise-constant rows of ``shape``: about 2% of ticks change."""
    import torch
    steps = (torch.rand(shape, generator=gen) < 0.02).cumsum(-1)
    if dtype == torch.bool:
        return (steps % 2).bool()
    return (steps % 3).to(dtype)


def hold_shapes(dev, errs: dict, label: str, shapes: dict) -> None:
    """Hold the kernels at shapes recorded by :func:`record_shapes`
    against their plain versions on the card: ``sliding_assoc`` on
    N(100, 5) rows (sums within a few ulps of a float64 sum, max/min
    exact), ``seg_dirty`` on piecewise-constant rows of the recorded dtypes
    (exact), ``prefix_scan`` on N(0, 1) rows of the recorded dtype and
    alignment (as phase 2 holds it: against the float64 scan)."""
    import torch
    from repro_torch.kernels import ref, sparse_compact as sc
    from repro_torch.kernels import window_reduce as wr
    gen = torch.Generator(device="cpu").manual_seed(3)
    for R, T, W, op, _calls in shapes["sliding_assoc"]:
        x = (torch.randn(R, T, generator=gen) * 5 + 100).to(dev)
        combine, ident, _ = wr.COMBINES[op]
        got = wr.sliding_assoc(x, W, op)
        plain = ref.sliding_assoc_block_ref(x, W, combine, ident)
        what = f"sliding_assoc {label} ({R},{T}) W={W} {op}"
        if op == "add":
            e = sum_check(what, got, plain, ref.sliding_assoc_block_ref(
                x.double(), W, torch.add, 0.0))
        else:
            e = exact_check(what, got, plain)
        errs["sliding_assoc"] = max(errs["sliding_assoc"], e)
    for mats, geoms, n_segs, _calls in shapes["seg_dirty"]:
        rows = [_changes(shape, dtype, gen).to(dev) for shape, dtype in mats]
        got = sc.seg_dirty(rows, list(geoms), n_segs)
        want = ref.seg_dirty_fused_ref(rows, list(geoms), n_segs)
        if not torch.equal(got, want):
            raise AssertionError(f"seg_dirty {label} {geoms}: kernel != "
                                 "plain")
    prefix = shapes.get("prefix_scan", [])
    for R, T, dtype, aligned, _calls in prefix:
        x = torch.randn(R, T, generator=gen).to(dev).to(dtype).contiguous()
        if not aligned:
            x = misaligned(x)
        e = sum_check(f"prefix_scan {label} ({R},{T}) {dtype}",
                      wr.prefix_scan(x), ref.prefix_sum_ref(x.float()),
                      torch.cumsum(x.double(), dim=-1))
        errs["prefix_scan"] = max(errs["prefix_scan"], e)
    log(f"{label}: sliding_assoc at {len(shapes['sliding_assoc'])} shapes, "
        f"seg_dirty at {len(shapes['seg_dirty'])} geometries and "
        f"prefix_scan at {len(prefix)} shapes recorded on the path agree "
        "with their plain versions")


def time_runner_shapes(dev, errs: dict, rows: dict, runners: dict):
    """Phase 2 at the runners' own shapes (recorded from the dense runs of
    phases 5-6): each against its plain version, then the event time, the
    bound, the PyTorch call's time and the launches per timed run."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, window_reduce as wr
    gen = torch.Generator(device="cpu").manual_seed(2)
    for cell in ("fraud_single", "fraud_keyed_1"):
        row = runners[cell]["dense"]
        per_chunk = row["sliding_shapes_per_chunk"]
        for R, T, W, op, calls in per_chunk:
            x = (torch.randn(R, T, generator=gen) * 5 + 100).to(dev)
            combine, ident, _ = wr.COMBINES[op]
            got = wr.sliding_assoc(x, W, op)
            plain = ref.sliding_assoc_block_ref(x, W, combine, ident)
            if op == "add":
                e = sum_check(f"sliding_assoc runner ({R},{T})", got, plain,
                              ref.sliding_assoc_block_ref(
                                  x.double(), W, torch.add, 0.0))
                filt = torch.ones(1, 1, W, device=dev)
                lib = lambda: F.conv1d(x.unsqueeze(1), filt, padding=W - 1)
            else:
                e = exact_check(f"sliding_assoc runner ({R},{T}) {op}", got,
                                plain)
                xp = F.pad(x, (W - 1, 0), value=ident)
                sign = 1.0 if op == "max" else -1.0
                lib = lambda: F.max_pool1d(sign * xp.unsqueeze(1), W,
                                           stride=1)
            errs["sliding_assoc"] = max(errs["sliding_assoc"], e)
            t = {"ms": cuda_ms(lambda: wr.sliding_assoc(x, W, op)),
                 "plain_ms": cuda_ms(lambda: ref.sliding_assoc_block_ref(
                     x, W, combine, ident)),
                 "library_ms": cuda_ms(lib),
                 "device_ms": kernel_device_ms(
                     lambda: wr.sliding_assoc(x, W, op), ""),
                 "host_ms": host_ms(lambda: wr.sliding_assoc(x, W, op))}
            b, by = bound(8.0 * R * T, 2.0 * R * T)
            launches = calls * row["chunks"]
            plan = wr.sliding_plan(R, T, W)
            rows[("sliding_assoc", f"{cell} {R}x{T}")] = dict(
                t, max_abs_err=e, bound_ms=b, bound_by=by, shape=[R, T],
                window=W, op=op, launches_per_timed_run=launches,
                regime=plan.regime, blocks=plan.blocks)
            log(f"sliding_assoc {cell} ({R},{T}) W={W} {op} "
                f"[{plan.regime}, {plan.blocks} blocks]: {t['ms']:.4f} ms, "
                f"device {_ms(t['device_ms'])}, "
                f"plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, wrapper host "
                f"{t['host_ms']:.4f} ms; bound {b:.4f} ms ({by}); "
                f"{launches} launches per timed run")


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
    to ``main_launches``.  Returns the call's result and seconds.  Garbage
    left by earlier calls (runners of finished cells, which hold graphs
    and their memory pools) is collected first, outside the window."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for k, n in launch_counts().items():
        main_launches[k] = main_launches.get(k, 0) + n
    return res, dt


def _log_findings(where: str, findings) -> None:
    """Every warning and error, with its provenance."""
    for f in findings:
        if f.severity != "info":
            log(f"  {where}: [{f.severity}] {f.pass_name}/{f.code} :: "
                f"{f.target or '-'} @ {f.provenance or '-'}")


def audit_cell(label: str, runner) -> str:
    """Phase 12(c): every pass of the static audit over one runner cell,
    after its timed run and outside its launch-count windows; the kernel
    shapes it launches are recorded for 12(d).  Warnings are printed with
    their provenance; an error finding fails the script."""
    from repro_torch.analysis import audit_runner, verdict
    t0 = time.perf_counter()
    findings = recording(AUDITS["shapes"], lambda: audit_runner(runner))()
    dt = time.perf_counter() - t0
    v = verdict(findings)
    AUDITS["cells"][label] = {
        "verdict": v, "seconds": dt,
        "findings": [f.to_json() for f in findings if f.severity != "info"]}
    _log_findings(f"audit {label}", findings)
    if v == "error":
        raise AssertionError(f"audit of {label}: error findings")
    return v


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
        short = _kernel_name(e.name)
        per_kernel[short] = (per_kernel.get(short, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    if not spans:
        return {"device_ms": None, "idle_share": None, "top": [],
                "per_kernel": {}}
    busy_us, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy_ms = busy_us / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:4]
    return {"device_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / (wall_s * 1e3)),
            "top": [[k, v] for k, v in top], "per_kernel": per_kernel}


def _kernel_name(raw: str) -> str:
    """A device event's kernel name without its namespace, template and
    parameters; a mangled name (``_Z...``, as CUPTI may report a kernel
    inside a conditional graph body) is cut to its innermost
    identifier."""
    if raw.startswith("_Z"):
        i, parts = (3 if raw.startswith("_ZN") else 2), []
        while i < len(raw) and raw[i].isdigit():
            j = i
            while j < len(raw) and raw[j].isdigit():
                j += 1
            n = int(raw[i:j])
            parts.append(raw[j:j + n])
            i = j + n
        if parts:
            return parts[-1][:40]
    short = raw.replace("(anonymous namespace)::", "")
    short = short.removeprefix("void ").split("<")[0].split("(")[0]
    return short.split("::")[-1].strip()[:40]


def _replay_profile(fn) -> dict:
    """One replay ``fn()`` timed two ways at once: ``torch.profiler``'s
    busy time (union of the device events it reports), their count and
    the kernels it names, and the CUDA-event span around it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
    spans, named = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = _kernel_name(e.name)
        named[k] = named.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, -float("inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {"busy_ms": busy / 1e3, "event_ms": a.elapsed_time(b),
            "device_events": len(spans),
            "sliding_ms": sum(v for k, v in named.items()
                              if k.startswith("sliding")),
            "top": sorted(([k, v] for k, v in named.items()),
                          key=lambda kv: -kv[1])[:6]}


def replay_check(runner) -> dict:
    """Whether ``torch.profiler`` sees the kernels of a switched sparse
    graph's conditional body.  One steady replay of the whole switched
    graph (prefix, the picked body inside a conditional node, suffix; no
    copy in or out), then its three parts replayed one by one as plain
    graphs on the same buffers (the body the count picks); each profiled
    and spanned by CUDA events (:func:`_replay_profile`).  If the whole
    replay shows fewer device events than its parts (plus its one bucket
    pick), the profiler dropped the body's kernels and a step's busy time
    lacks them.  The runner is left mid-stream (its buffers are replayed
    as they are): use one no longer needed."""
    g = runner._work.graphs[("sparse", False)]
    prefix, bodies, suffix, count, caps = g._parts
    for _ in range(2):
        g.replay()
    whole = _replay_profile(g.replay)
    pre = _replay_profile(prefix.replay)
    n, ladder = int(count.item()), caps.tolist()
    pick = next((i for i, c in enumerate(ladder) if c >= n),
                len(ladder) - 1)
    parts = {"prefix": pre, "body": _replay_profile(bodies[pick].replay),
             "suffix": _replay_profile(suffix.replay)}
    busy = sum(p["busy_ms"] for p in parts.values())
    events = sum(p["device_events"] for p in parts.values())
    return {"whole": whole, "parts": parts, "count": n,
            "capacity": ladder[pick], "parts_busy_ms": busy,
            "parts_events": events,
            "parts_event_ms": sum(p["event_ms"] for p in parts.values()),
            "body_dropped": whole["device_events"] < events + 1}


def _replay_text(r: dict) -> str:
    w, b = r["whole"], r["parts"]["body"]
    return (f"switched replay: profiler busy {w['busy_ms']:.4f} ms over "
            f"{w['device_events']} device events, CUDA-event span "
            f"{w['event_ms']:.4f} ms, sliding {w['sliding_ms']:.4f} ms; its "
            f"parts one by one (capacity {r['capacity']} for count "
            f"{r['count']}): busy {r['parts_busy_ms']:.4f} ms over "
            f"{r['parts_events']} events, spans {r['parts_event_ms']:.4f} "
            f"ms; body alone {b['busy_ms']:.4f} ms over {b['device_events']} "
            f"events, sliding {b['sliding_ms']:.4f} ms; body kernels dropped "
            f"by the profiler: {r['body_dropped']}")


def _profile_text(p: dict) -> str:
    if p["device_ms"] is None:
        return "device time not reported by torch.profiler"
    return (f"device busy {p['device_ms']:.4f} ms, idle share "
            f"{p['idle_share']:.3f}; " + ", ".join(
                f"{k} {v:.4f}" for k, v in p["top"]))


def _bits_equal(a, b) -> bool:
    """Two output grids the same bits at every tick, φ ticks included."""
    import torch
    from torch.utils._pytree import tree_leaves
    la, lb = tree_leaves((a.value, a.valid)), tree_leaves((b.value, b.valid))
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))
        for x, y in zip(la, lb))


def staged_against_eager(label: str, staged, eager, per: int,
                         replays: int, syncs=0) -> dict:
    """A staged one-shot call beside the same call compiled with
    ``jit=False`` (eager), outside every launch-count window: both after
    their first use, timed in turns (eager, staged, staged, eager; the
    smaller of each), their device busy time and idle share by
    ``torch.profiler``, their span on the card by CUDA events (from before
    a call's first operation to after its last, the smallest of three: a
    check on the profiler, which can drop a replay's device events), each
    call's synchronizing calls, and the staged call's graph replays, which
    must be ``replays`` (its syncs ``syncs``, unless ``None``).  ``per``
    divides the times (partitions a call)."""
    from repro_torch.engine import capture
    staged()
    eager()
    _, te1 = _timed(eager)
    _, ts1 = _timed(staged)
    _, ts2 = _timed(staged)
    _, te2 = _timed(eager)
    ts, te = min(ts1, ts2), min(te1, te2)
    r0 = capture.replays["graph"]
    n_syncs = count_syncs(staged)
    n_replays = capture.replays["graph"] - r0
    eager_syncs = count_syncs(eager)
    if (syncs is not None and n_syncs != syncs) or n_replays != replays:
        raise AssertionError(f"{label}: a steady staged call made {n_syncs} "
                             f"synchronizing calls (want {syncs}) and "
                             f"{n_replays} replays (want {replays})")
    ps, pe = device_profile(staged, ts), device_profile(eager, te)
    out = {"staged_ms": ts * 1e3 / per, "eager_ms": te * 1e3 / per,
           "staged_busy_ms": _per(ps["device_ms"], per),
           "eager_busy_ms": _per(pe["device_ms"], per),
           "staged_idle": ps["idle_share"], "eager_idle": pe["idle_share"],
           "staged_span_ms": _span_ms(staged) / per,
           "eager_span_ms": _span_ms(eager) / per,
           "staged_syncs": n_syncs, "eager_syncs": eager_syncs,
           "replays": n_replays}
    log(f"  {label}: staged {out['staged_ms']:.4f} ms (busy "
        f"{_fmt(out['staged_busy_ms'])}, idle {_fmt(ps['idle_share'])}, "
        f"span {out['staged_span_ms']:.4f}, {n_syncs} syncs, {n_replays} "
        f"replays) against jit=False {out['eager_ms']:.4f} ms (busy "
        f"{_fmt(out['eager_busy_ms'])}, idle {_fmt(pe['idle_share'])}, span "
        f"{out['eager_span_ms']:.4f}, {eager_syncs} syncs), a "
        f"{'partition' if per > 1 else 'call'}; x{te / ts:.2f}")
    return out


def _span_ms(fn, reps: int = 3) -> float:
    """The smallest CUDA-event span of ``fn()`` on the current stream."""
    import torch
    spans = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        spans.append(a.elapsed_time(b))
    return min(spans)


def _per(v, n: int):
    return None if v is None else v / n


def _fmt(v) -> str:
    return "not reported" if v is None else f"{v:.4f}"


def hold_bits(label: str, staged, eager) -> None:
    """The staged call and its ``jit=False`` twin on integer data: the
    same bits at every tick."""
    if not _bits_equal(staged(), eager()):
        raise AssertionError(f"{label}: staged != jit=False on integer "
                             "data")


def _floored(data: dict) -> dict:
    """An app's inputs floored to integers (validity kept)."""
    out = {}
    for name, d in data.items():
        v = d["value"]
        out[name] = dict(d, value=({k: np.floor(a) for k, a in v.items()}
                                   if isinstance(v, dict) else np.floor(v)))
    return out


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
        exe, eager = (qc.compile_query(app.query.node,
                                       out_len=part // app.query.prec,
                                       sum_algo=algo, jit=jit)
                      for jit in (True, False))
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
        log(f"app {name:10s} {algo:5s}: {n_ticks / dt:.4g} events/s "
            f"({dt * 1e3:.2f} ms for {n_parts} partitions of {part}); "
            f"vs cpu max diff {stats['max_abs_diff']:.3g}, "
            f"{stats['flips']} gate flips")
        log(f"  one partition: {_profile_text(prof)}")
        del res
        vs = staged_against_eager(
            f"{name} {algo}", lambda: partition_run(exe, grids, 0, n_parts),
            lambda: partition_run(eager, grids, 0, n_parts), n_parts,
            replays=n_parts)
        del grids
        ints = A.make_grids(_floored(data), device=dev)
        hold_bits(f"{name} {algo}",
                  lambda: partition_run(exe, ints, 0, n_parts),
                  lambda: partition_run(eager, ints, 0, n_parts))
        out[f"{name}/{algo}"] = dict(stats, events_per_s=n_ticks / dt,
                                     seconds=dt, profile=prof, staged=vs)
        del ints
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
        exe, eager = (qc.compile_query(app.query.node,
                                       out_len=n_ticks // app.query.prec,
                                       jit=jit) for jit in (True, False))
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
        log(f"keyed {name:6s}: {events / dt:.4g} events/s ({dt * 1e3:.2f} "
            f"ms for {n_keys} keys x {n_ticks} ticks); vs cpu max diff "
            f"{stats['max_abs_diff']:.3g}, {stats['flips']} gate flips")
        log(f"  one batch: {_profile_text(prof)}")
        del res
        vs = staged_against_eager(f"batch_run {name}",
                                  lambda: batch_run(exe, grids),
                                  lambda: batch_run(eager, grids), 1,
                                  replays=1)
        del grids
        ints = A.make_grids(_floored(data), device=dev)
        hold_bits(f"batch_run {name}", lambda: batch_run(exe, ints),
                  lambda: batch_run(eager, ints))
        out[name] = dict(stats, events_per_s=events / dt, seconds=dt,
                         profile=prof, staged=vs)
        del ints
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
    from repro_torch.serve import aot_capture
    keys = "vmapped" if n_keys > 1 else "single"
    kw = dict(n_keys=n_keys if n_keys > 1 else None, segs_per_chunk=spc)
    span = seg * spc
    events = n_keys * span * n_chunks
    out, res = {}, {}
    for body in ("dense", "sparse"):
        exe = qc.compile_query(query, out_len=seg, sparse=body == "sparse")
        policy = ExecPolicy(body=body, keys=keys)
        # first use of every step; the kernel shapes of its two chunks
        shapes = record_shapes(
            lambda: Runner(exe, policy, **kw).run(grids, 2))["sliding_assoc"]
        r = Runner(exe, policy, **kw)
        launches = {}
        # every step captured ahead, as a served runner's is: the timed run
        # excludes the first use of each step (its launches still count)
        drive(launches, lambda: aot_capture(r, chunks=_chunk(grids, 0, span)))
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
        syncs = count_syncs(lambda: rp.step(_chunk(grids, 3, span)))
        if syncs:
            raise AssertionError(f"runner {label} {body}: a steady chunk "
                                 f"made {syncs} synchronizing calls")
        replay = replay_check(rp) if body == "sparse" else None
        audit = audit_cell(f"runner {label} {body}", r)
        cpu_kw = dict(kw, n_keys=CMP_KEYS) if n_keys > 1 else kw
        cpu = Runner(exe, policy, **cpu_kw).run(cpu_grids, CMP_CHUNKS)
        n_cmp = CMP_CHUNKS * span
        stats = compare(tol, _head(res[body], n_cmp, CMP_KEYS if n_keys > 1
                                   else 0), cpu)
        row = dict(stats, events_per_s=events / dt, seconds=dt,
                   ms_per_chunk=dt / n_chunks * 1e3, profile=prof,
                   host_reads_per_chunk=syncs,
                   launches_per_chunk={k: n / n_chunks
                                       for k, n in launches.items()},
                   chunks=n_chunks, metrics=snap, replay=replay,
                   audit=audit,
                   sliding_shapes_per_chunk=[[*k[:4], k[4] / 2]
                                             for k in shapes])
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
            f"chunk: {per}; host reads per steady chunk {syncs}; vs cpu max "
            f"diff {stats['max_abs_diff']:.3g}, {stats['flips']} gate flips; "
            f"audit={audit}")
        slid = sum(v for k, v in prof["per_kernel"].items()
                   if k.startswith("sliding"))
        log(f"  one chunk: {_profile_text(prof)}; sliding_assoc kernels "
            f"{slid:.4f} ms")
        if replay is not None:
            log(f"  {_replay_text(replay)}")
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
    exe, eager = (qc.compile_query(streams.fraud_query(FRAUD_WINDOW).node,
                                   out_len=seg, sparse=True, jit=jit)
                  for jit in (True, False))
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
    # the burst stream is integer-valued: staged ≡ jit=False bit for bit
    vs = {}
    for fused in (True, False):
        hold_bits(f"sparse_run fused={fused}",
                  lambda f=fused: sparse_run(exe, grids, 0, n_parts, fused=f),
                  lambda f=fused: sparse_run(eager, grids, 0, n_parts,
                                             fused=f))
        # fused: one switched graph, no host read; three-phase: the mask
        # eagerly (its planning ranges reach the card every call), the
        # count's host read, then one graph: its syncs are only printed
        vs[f"fused={fused}"] = staged_against_eager(
            f"sparse_run fused={fused}",
            lambda f=fused: sparse_run(exe, grids, 0, n_parts, fused=f),
            lambda f=fused: sparse_run(eager, grids, 0, n_parts, fused=f),
            1, replays=1, syncs=0 if fused else None)
    return dict(stats, events_per_s=n / dt, seconds=dt,
                dense_events_per_s=n / dt_d, dense_seconds=dt_d,
                dirty_fraction=dirty / segs, profile=prof, staged=vs)


# ---------------------------------------------------------------------------
# phase 8: multi-query sharing; phase 9: out-of-order ingestion
# ---------------------------------------------------------------------------

def count_syncs(fn) -> int:
    """Synchronizing calls (device reads) ``fn`` makes, by PyTorch's sync
    debug mode."""
    import warnings
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def active_keys(n_keys: int, rate: float, seed: int) -> np.ndarray:
    """The sorted keys that stay active at ``rate`` (phase 6's active keys:
    ``streams.keyed_activity`` picks them the same way)."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_keys, size=max(1, int(round(n_keys * rate))),
                              replace=False))


def held_keys(walks: np.ndarray, rate: float, seed: int) -> np.ndarray:
    """``rate`` of the keys keep their walks, the rest hold their first
    value."""
    act = active_keys(walks.shape[0], rate, seed)
    out = np.broadcast_to(walks[:, :1], walks.shape).copy()
    out[act] = walks[act]
    return out


def compared_keys(n_keys: int, rate: float) -> np.ndarray:
    """The ``CMP_KEYS`` keys a keyed session cell holds against the CPU:
    the first ones, and at a rate below 1 half of them active keys, so the
    held and the changing keys are both compared."""
    if rate >= 1.0:
        return np.arange(CMP_KEYS)
    act = active_keys(n_keys, rate, 0)[:CMP_KEYS // 2]
    rest = np.setdiff1d(np.arange(n_keys), act)[:CMP_KEYS - len(act)]
    return np.union1d(act, rest)


def _pick(grid, n: int, sel):
    """The first ``n`` output ticks (of the keys ``sel``) on the host."""
    import torch
    v, m = grid.value[..., :n], grid.valid[..., :n]
    if sel is not None:
        i = torch.as_tensor(sel, device=v.device)
        v, m = v[i], m[i]
    return grid.replace(value=v.cpu(), valid=m.cpu())


def _is_vol_head(name: str) -> bool:
    """The dashboard's breakout and momentum heads read the stddev."""
    return int(name[1:]) % 4 >= 2


def _hold_heads(label: str, got: dict, want: dict, exact: bool):
    """Per dashboard head.  ``exact``: every head bit for bit (the same
    kernels over the same buffers: a session against its solo runners).
    Otherwise, the card against the CPU on the random walks: the trend
    heads within ``tolerance``'s ``dashboard`` limits, the stddev heads
    finite where valid, with momentum's validity that of its inputs (see
    tolerance.py; :func:`_hold_int_heads` holds them to a number on
    integer prices).  Returns the largest trend-head difference and the
    largest stddev-head one."""
    import torch
    worst, vol = 0.0, 0.0
    for q in sorted(want):
        g, w = got[q], want[q]
        if exact:
            if not _same_bits(g, w):
                raise AssertionError(f"{label} {q}: not bit-identical")
            continue
        if _is_vol_head(q):
            gv, wv = g.value.cpu(), w.value.cpu()
            gm, wm = g.valid.cpu(), w.valid.cpu()
            if not torch.isfinite(gv[gm]).all():
                raise AssertionError(f"{label} {q}: non-finite values")
            if int(q[1:]) % 4 == 3 and not torch.equal(gm, wm):
                raise AssertionError(f"{label} {q}: momentum validity")
            both = gm & wm
            if both.any():
                vol = max(vol, float((gv[both] - wv[both]).abs().max()))
            continue
        # a trend head thresholds its difference at +-thr: centre both
        # on it, so the gate excuses flips at the head's own threshold
        i = int(q[1:])
        edge = 0.05 * (i // 4) * (1 if i % 4 == 0 else -1)
        worst = max(worst, compare(
            "dashboard", g.replace(value=g.value - edge),
            w.replace(value=w.value - edge))["max_abs_diff"])
    return worst, vol


def _hold_int_heads(label: str, got: dict, want: dict) -> float:
    """Every dashboard head of the card against the CPU on integer prices
    within ``MQ_STD_TOL``, finite where both are valid; a head's validity
    may differ only where the CPU's value lies within ``MQ_STD_TOL`` of 0
    (a breakout at its threshold).  Returns the largest difference."""
    import torch
    worst = 0.0
    for q in sorted(want):
        gv, gm = got[q].value, got[q].valid
        wv, wm = want[q].value, want[q].valid
        if gv.shape != wv.shape:
            raise AssertionError(f"{label} {q}: {gv.shape} vs {wv.shape}")
        both = gm & wm
        if not torch.isfinite(gv[both]).all():
            raise AssertionError(f"{label} {q}: non-finite values")
        d = float((gv[both] - wv[both]).abs().max()) if both.any() else 0.0
        if d > MQ_STD_TOL or (wv[gm != wm].abs() > MQ_STD_TOL).any():
            raise AssertionError(f"{label} {q}: max diff {d} or a validity "
                                 f"flip beyond {MQ_STD_TOL}")
        worst = max(worst, d)
    return worst


def _near_heads(label: str, got: dict, want: dict) -> float:
    """Sparse against dense on the random walks at 1% active keys, on the
    card over every key and chunk.  A held key's windows sum one constant
    float, which a dense chunk adds in another order than the chunk whose
    outputs the sparse body holds, so only integer prices are bit for bit
    (:func:`run_sessions`).  The trend heads within ``tolerance``'s
    ``dashboard`` limits (a validity flip only within its gate of the
    head's threshold); the stddev heads finite where valid, momentum with
    the validity of its inputs (a held key's stddev is the f32
    cancellation noise of E[x^2] - E[x]^2, see tolerance.py).  Returns
    the largest trend-head difference."""
    import torch
    from repro_torch.data.tolerance import TOLERANCE
    atol, rtol, gate = TOLERANCE["dashboard"]
    worst = 0.0
    for q in sorted(want):
        g, w = got[q], want[q]
        i = int(q[1:])
        bad = ~torch.isfinite(g.value) & g.valid
        if i % 4 == 3:
            bad |= g.valid != w.valid
        elif i % 4 < 2:
            both = g.valid & w.valid
            d = torch.where(both, (g.value - w.value).abs(), 0.0)
            edge = 0.05 * (i // 4) * (1 if i % 4 == 0 else -1)
            bad |= d > atol + rtol * w.value.abs()
            bad |= (g.valid != w.valid) & ((w.value - edge).abs() > gate)
            worst = max(worst, float(d.max()))
        if bool(bad.any()):
            raise AssertionError(f"{label} {q}: beyond the dashboard limits")
    return worst


def _dash_session(qs: dict, span: int, n_keys: int, sparse: bool):
    from repro_torch.multiquery import MultiQuerySession
    sess = MultiQuerySession(span, n_keys=n_keys if n_keys > 1 else None,
                             sparse=sparse)
    for name, q in qs.items():
        sess.attach(name, q)
    return sess


def run_int_session(dev, label: str, n_keys: int, span: int, n_chunks: int,
                    sparse: bool, rate: float) -> tuple:
    """A phase-8 cell on well-conditioned data, outside the launch-count
    windows: the same session at the same shapes over integer prices in
    [0, 16) (the CPU tests' data: f32 window sums and sums of squares over
    them are exact, so the stddev is well conditioned), the inactive keys
    held as in the cell; every head of the first ``CMP_CHUNKS`` chunks (of
    :func:`compared_keys`) against the CPU by :func:`_hold_int_heads`.
    Returns the largest difference and the card's outputs."""
    from repro_torch.data import apps as A
    keyed = n_keys > 1
    rng = np.random.default_rng(7)
    n_ticks = span * n_chunks
    vals = np.floor(rng.random((n_keys, n_ticks) if keyed else n_ticks)
                    * 16).astype(np.float32)
    sel = None
    if keyed:
        vals = vals if rate >= 1.0 else held_keys(vals, rate, 0)
        sel = compared_keys(n_keys, rate)
    qs = A.dashboard_queries(MQ_QUERIES, keyed=keyed)
    card = _dash_session(qs, span, n_keys, sparse).run(
        {"in": _grid(vals, dev)}, n_chunks)
    n_cmp = CMP_CHUNKS * span
    few = vals[sel, :n_cmp] if keyed else vals[:n_cmp]
    cpu = _dash_session(qs, span, len(sel) if keyed else 1, sparse).run(
        {"in": _grid(few, "cpu")}, CMP_CHUNKS)
    worst = _hold_int_heads(f"{label} integer prices",
                            {q: _pick(g, n_cmp, sel)
                             for q, g in card.items()}, cpu)
    return worst, card


def run_session(dev, main_launches: dict, label: str, vals: np.ndarray,
                span: int, sparse: bool, solo: bool, rate: float = 1.0):
    """One phase-8 cell: ``MQ_QUERIES`` dashboard queries in one
    ``MultiQuerySession`` over ``vals`` (``(T,)`` or ``(K, T)``) in chunks of
    ``span``, timed on the card; against ``MQ_QUERIES`` solo runners over
    the same chunks (``solo``), for ``CMP_CHUNKS`` chunks (of
    :func:`compared_keys`) against the CPU, and on integer prices
    (:func:`run_int_session`)."""
    from repro_torch.core import compile as qc
    from repro_torch.data import apps as A
    from repro_torch.engine import ExecPolicy, Runner
    keyed = vals.ndim > 1
    n_keys = vals.shape[0] if keyed else 1
    n_chunks = vals.shape[-1] // span
    grids = {"in": _grid(vals, dev)}
    qs = A.dashboard_queries(MQ_QUERIES, keyed=keyed)

    def session(keys=n_keys):
        return _dash_session(qs, span, keys, sparse)

    session().run(grids, 2)                      # first use of every shape
    sess = session()
    launches = {}
    drive(launches, lambda: sess.prepare(_chunk(grids, 0, span)))
    res, dt = drive(launches, lambda: sess.run(grids, n_chunks))
    for k, n in launches.items():
        main_launches[k] = main_launches.get(k, 0) + n
    snap = sess.metrics.snapshot()
    rep = sess.sharing_report()
    # one steady chunk: device busy time and idle share, then host reads
    rp = session()
    rp.step(_chunk(grids, 0, span))
    rp.step(_chunk(grids, 1, span))
    prof = device_profile(lambda: rp.step(_chunk(grids, 2, span)),
                          dt / n_chunks)
    syncs = count_syncs(lambda: rp.step(_chunk(grids, 3, span)))
    if syncs:
        raise AssertionError(f"session {label}: a steady chunk made {syncs} "
                             "synchronizing calls")
    if sparse:
        replay = replay_check(rp.runner)
        prof["replay"] = replay
    audit = audit_cell(f"session {label} {'sparse' if sparse else 'dense'}",
                       sess.runner)
    events = MQ_QUERIES * n_keys * span * n_chunks
    row = dict(events_per_s=events / dt, seconds=dt,
               ms_per_chunk=dt / n_chunks * 1e3, profile=prof,
               host_reads_per_chunk=syncs, chunks=n_chunks,
               sharing={"shared": rep.shared_nodes,
                        "union": rep.union_nodes,
                        "independent": rep.independent_nodes},
               launches_per_chunk={k: n / n_chunks
                                   for k, n in launches.items()},
               metrics=snap, audit=audit)
    if sparse:
        st = sess.runner.dirty_stats()
        row["dirty_fraction"] = st["compact"]
    if solo:
        outs = {}
        for name, q in qs.items():
            r = Runner(qc.compile_query(q.node, out_len=span),
                       ExecPolicy(keys="vmapped" if keyed else "single"),
                       n_keys=n_keys if keyed else None)
            outs[name] = r.run(grids, n_chunks)
        _hold_heads(f"{label} vs solo", res, outs, exact=True)
        del outs
    n_cmp = CMP_CHUNKS * span
    sel = compared_keys(n_keys, rate) if keyed else None
    few = vals[sel, :n_cmp] if keyed else vals[:n_cmp]
    cpu = session(len(sel) if keyed else 1).run({"in": _grid(few, "cpu")},
                                                CMP_CHUNKS)
    heads = {q: _pick(g, n_cmp, sel) for q, g in res.items()}
    row["vs_cpu_max_diff"], row["vs_cpu_vol_max_diff"] = _hold_heads(
        f"{label} vs cpu", heads, cpu, exact=False)
    del grids
    row["int_vs_cpu_max_diff"], ints = run_int_session(
        dev, label, n_keys, span, n_chunks, sparse, rate)
    per = ", ".join(f"{k} {n / n_chunks:g}" for k, n in launches.items()
                    if n)
    dirty = (f", dirty fraction {row['dirty_fraction']:.4f}" if sparse
             else "")
    log(f"session {label} {'sparse' if sparse else 'dense '}: "
        f"{events / dt:.4g} events/s over {MQ_QUERIES} queries, "
        f"{dt / n_chunks * 1e3:.3f} ms per chunk{dirty}; launches per "
        f"chunk: {per}; host reads per chunk {syncs}; sharing "
        f"{rep.shared_nodes} shared / {rep.union_nodes} union nodes "
        f"({rep.independent_nodes} if run apart)"
        + (f"; all heads bit for bit against {MQ_QUERIES} solo runners"
           if solo else "")
        + f"; vs cpu: trend heads max diff {row['vs_cpu_max_diff']:.3g}, "
        f"stddev heads max diff {row['vs_cpu_vol_max_diff']:.3g} (random "
        f"walk); all heads max diff {row['int_vs_cpu_max_diff']:.3g} "
        f"(integer prices); audit={audit}")
    log(f"  one chunk: {_profile_text(prof)}")
    if sparse:
        log(f"  {_replay_text(prof['replay'])}")
    return row, res, ints


def _same_heads(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(_same_bits(a[q], b[q]) for q in a)


def run_sessions(dev, main_launches: dict) -> dict:
    """Phase 8: the dashboard fan-out, unkeyed (dense) and keyed (dense and
    sparse, at 100% and at 1% active keys)."""
    from repro_torch.data import apps as A
    out = {}
    vals = A.dashboard_input(MQ_TICKS, 5)["in"]["value"].astype(np.float32)
    out["unkeyed"], *_ = run_session(
        dev, main_launches, "dashboard 2**24", vals, MQ_SPAN, sparse=False,
        solo=True)
    walks = A.dashboard_keyed_input(MQ_KEYS, MQ_KEY_TICKS, 5)["in"]["value"]
    for rate in (1.0, 0.01):
        vals = (walks if rate >= 1.0 else held_keys(walks, rate, 0)
                ).astype(np.float32)
        res, ints = {}, {}
        for sparse in (False, True):
            key = f"keyed_{rate:g}_{'sparse' if sparse else 'dense'}"
            out[key], res[sparse], ints[sparse] = run_session(
                dev, main_launches, f"keyed dashboard {MQ_KEYS} keys, "
                f"{rate:.0%} active", vals, MQ_KEY_SPAN, sparse=sparse,
                solo=rate >= 1.0 and not sparse, rate=rate)
        what = f"keyed session {rate:.0%} active"
        if not _same_heads(ints[True], ints[False]):
            raise AssertionError(f"{what}, integer prices: sparse != dense")
        if rate >= 1.0:
            if not _same_heads(res[True], res[False]):
                raise AssertionError(f"{what}: sparse != dense")
            log(f"{what}: sparse outputs equal dense outputs bit for bit, "
                f"all {MQ_QUERIES} queries, random walks and integer prices")
        else:
            out[key]["vs_dense_max_diff"] = _near_heads(
                f"{what} sparse vs dense", res[True], res[False])
            log(f"{what}: sparse outputs equal dense outputs bit for bit on "
                f"integer prices, all {MQ_QUERIES} queries; on the random "
                f"walks trend heads max diff "
                f"{out[key]['vs_dense_max_diff']:.3g}, stddev heads finite")
        if rate < 1.0 and out[key]["dirty_fraction"] >= 0.5:
            raise AssertionError(f"keyed session 1%: dirty fraction "
                                 f"{out[key]['dirty_fraction']}")
        del res, ints
    return out


def ooo_arrivals(vals: np.ndarray, rate: float, lateness: int, rng):
    """``fig_ooo``'s arrival order: one event per tick; a ``rate`` fraction
    displaced by up to two chunks (past any allowance), the rest jittered
    within ``lateness``.  Returns ``(arrival key, event)`` pairs, so keyed
    streams can be merged by arrival."""
    from repro_torch.core.stream import Event
    n = len(vals)
    max_disp = 2 * OOO_SEG * OOO_SPC
    late = rng.random(n) < rate
    jitter = rng.integers(0, max(1, lateness // 2), size=n)
    disp = np.where(late, rng.integers(lateness + 1, max_disp, size=n),
                    jitter)
    order = np.argsort(np.arange(n) + disp, kind="stable")
    return [(int(t + disp[t]), Event(int(t), int(t) + 1, float(vals[t])))
            for t in order]


def _overlay(sealed: list, corrections: list):
    """Sealed outputs with every correction's dirty segments laid over them
    in version order, stitched along time, on the card."""
    import torch
    final = {s.chunk: (s.outputs.value.clone(), s.outputs.valid.clone())
             for s in sealed}
    for co in sorted(corrections, key=lambda c: (c.chunk, c.version)):
        v, m = final[co.chunk]
        mask = torch.from_numpy(np.repeat(np.asarray(co.seg_mask), OOO_SEG,
                                          axis=-1)).to(v.device)
        v.copy_(torch.where(mask, co.outputs.value, v))
        m.copy_(torch.where(mask, co.outputs.valid, m))
    cs = sorted(final)
    if cs != list(range(len(cs))):
        raise AssertionError(f"sealed chunks {cs[:5]}...")
    return (torch.cat([final[c][0] for c in cs], dim=-1),
            torch.cat([final[c][1] for c in cs], dim=-1))


def run_ingest_cell(dev, main_launches: dict, label: str, exe, vals,
                    arrivals: list, lateness: int, n_keys: int) -> dict:
    """One phase-9 cell: the arrivals into an ``IngestRunner`` with the
    ``revise`` policy, polled every ``OOO_POLL`` events; after ``flush()``
    the sealed outputs with every correction applied must equal an in-order
    ``Runner`` over the same events, bit for bit on the card.  The cell
    runs again on a fresh runner under ``torch.profiler`` for its device
    busy time and idle share."""
    import torch
    from repro_torch.engine import ExecPolicy, Runner
    from repro_torch.ingest import IngestRunner
    from repro_torch.serve import aot_capture
    keyed = n_keys > 1
    chunk = OOO_SEG * OOO_SPC
    horizon = -(-(2 * chunk + chunk) // chunk)

    def runner():
        return Runner(exe, ExecPolicy(body="sparse",
                                      keys="vmapped" if keyed else "single"),
                      n_keys=n_keys if keyed else None,
                      segs_per_chunk=OOO_SPC)

    def ingest_runner(launches):
        r = runner()
        ing = IngestRunner(r, lateness=lateness, policy="revise",
                           horizon_chunks=horizon, device=dev)
        drive(launches, lambda: aot_capture(r, chunks=r.example_chunks(dev)))
        return r, ing

    def go(ing):
        sealed, corrections = [], []
        for i, (key, ev) in enumerate(arrivals):
            ing.push("in", ev, key=key)
            if i % OOO_POLL == OOO_POLL - 1:
                s, c = ing.poll()
                sealed += s
                corrections += c
        s, c = ing.flush()
        return sealed + s, corrections + c

    r, ing = ingest_runner(main_launches)
    (sealed, corrections), dt = drive(main_launches, lambda: go(ing))
    got_v, got_m = _overlay(sealed, corrections)
    full = {"in": _grid(vals.astype(np.float32), dev)}
    want = runner().run(full, vals.shape[-1] // chunk)
    if not (torch.equal(got_m, want.valid)
            and torch.equal(got_v[got_m], want.value[want.valid])):
        raise AssertionError(f"ingest {label}: sealed + corrections != "
                             "in-order execution")
    audit = audit_cell(f"ingest {label}", r)
    c = r.metrics.snapshot()["counters"]
    n_events = len(arrivals)
    row = {k.split(".")[-1]: c[k]["value"] for k in (
        "ingest.late_events", "ingest.revised_events",
        "ingest.beyond_horizon", "ingest.dropped_events",
        "ingest.sealed_chunks", "ingest.corrections",
        "runner.revision_runs", "runner.revision_chunks",
        "runner.revision_units", "runner.dirty_units", "runner.units")}
    _, ing_p = ingest_runner({})
    prof = device_profile(lambda: go(ing_p), dt)
    row.update(events=n_events, seconds=dt, events_per_s=n_events / dt,
               ms_per_sealed_chunk=dt / len(sealed) * 1e3, profile=prof,
               horizon_chunks=horizon, lateness=lateness, audit=audit)
    log(f"ingest {label}: {n_events / dt:.4g} events/s ({dt:.2f} s, "
        f"{dt / len(sealed) * 1e3:.3f} ms per sealed chunk); "
        f"late {row['late_events']}, revised {row['revised_events']}, "
        f"revision runs {row['revision_runs']}, chunks "
        f"{row['revision_chunks']}, units {row['revision_units']}, "
        f"corrections {row['corrections']}; beyond horizon "
        f"{row['beyond_horizon']}, dropped {row['dropped_events']}; sealed "
        f"{row['sealed_chunks']} chunks, dirty units {row['dirty_units']}/"
        f"{row['units']}: sealed + corrections equal in-order execution bit "
        f"for bit; audit={audit}")
    log(f"  the whole cell: {_profile_text(prof)}")
    return row


def run_ingest(dev, main_launches: dict) -> dict:
    """Phase 9: ``fig_ooo``'s query and stream, late fractions 0.02 and
    0.1 at lateness 16 and 256; then keyed, 64 keys x 8192 ticks."""
    from repro_torch.core import compile as qc
    from repro_torch.core.frontend import TStream
    from repro_torch.data import streams
    out = {}
    for keyed in (False, True):
        s = TStream.source("in", prec=1, keyed=keyed)
        q = (s.window(32).mean()
             .join(s.window(64).mean(), lambda a, b: a - b))
        exe = qc.compile_query(q.node, out_len=OOO_SEG, sparse=True)
        if not keyed:
            vals = streams.burst_stream(OOO_TICKS, 0.05, 5)
            for rate in (0.02, 0.1):
                for lateness in (16, 256):
                    arr = ooo_arrivals(vals, rate, lateness,
                                       np.random.default_rng(17))
                    out[f"r{rate:g}_l{lateness}"] = run_ingest_cell(
                        dev, main_launches, f"late {rate:g}, lateness "
                        f"{lateness}", exe, vals,
                        [(None, ev) for _a, ev in arr], lateness, 1)
            continue
        rng = np.random.default_rng(17)
        vals = np.stack([streams.burst_stream(OOO_KEY_TICKS, 0.05, 5 + k)
                         for k in range(OOO_KEYS)])
        tagged = []
        for k in range(OOO_KEYS):
            tagged += [(a, k, ev) for a, ev in
                       ooo_arrivals(vals[k], 0.1, 16, rng)]
        tagged.sort(key=lambda x: (x[0], x[1]))
        out["keyed_r0.1_l16"] = run_ingest_cell(
            dev, main_launches, f"keyed {OOO_KEYS} keys, late 0.1, "
            "lateness 16", exe, vals, [(k, ev) for _a, k, ev in tagged],
            16, OOO_KEYS)
    return out


# ---------------------------------------------------------------------------
# phase 10: serving
# ---------------------------------------------------------------------------

def _serve_fraud(win: int = SERVE_WINDOW):
    """``benchmarks/fig_latency.py``'s served query: trailing mean and
    stddev, a threshold, the excess where it is positive."""
    from repro_torch.core.frontend import TStream
    s = TStream.source("in", prec=1)
    mu = s.window(win).mean().shift(1)
    sd = s.window(win).stddev().shift(1)
    thr = mu.join(sd, lambda m, d: m + 3.0 * d)
    return s.join(thr, lambda x, t: x - t).where(lambda e: e > 0)


def _host_requests(vals: np.ndarray, n: int):
    """Host numpy request grids of ``n`` ticks from ``vals`` (``(T,)`` or
    ``(K, T)``): the serving loop's only input."""
    from repro_torch.core.stream import SnapshotGrid
    for c in range(vals.shape[-1] // n):
        v = np.ascontiguousarray(vals[..., c * n:(c + 1) * n])
        yield {"in": SnapshotGrid(value=v, valid=np.ones(v.shape, bool),
                                  t0=c * n, prec=1)}


def _steady(svc, gen, calls: int):
    """``calls`` blocked results of the serving generator ``gen``, each
    timed on the host clock, all under PyTorch's sync debug mode set to
    raise on a synchronizing call; fails if a CUDA graph is captured
    meanwhile."""
    import torch
    tracer = svc.runner.metrics.tracer
    before = tracer.captures()
    dts, outs = np.empty(calls), []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for j in range(calls):
            t0 = time.perf_counter()
            outs.append(next(gen))
            dts[j] = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    late = {k: n - before.get(k, 0) for k, n in tracer.captures().items()
            if n != before.get(k, 0)}
    if late:
        raise AssertionError(f"CUDA graphs captured in the steady state: "
                             f"{late}")
    return dts, outs


def _joined(outs: list):
    """One grid of a served run's per-call results, along time."""
    import torch
    return outs[0].replace(value=torch.cat([o.value for o in outs], -1),
                           valid=torch.cat([o.valid for o in outs], -1))


def serve_latency(dev, main_launches: dict, errs: dict, tmp: str) -> dict:
    """``fig_latency``'s sweep: the served fraud query (sparse body) at
    per-call batches 1, 10, 100 and 1000 ticks, p50 and p99 of the host
    time per blocked call over its number of calls (warm-up calls
    dropped).  The kernel shapes each batch's steps launch (recorded while
    the service warms up, which captures every step) are held against
    their plain versions, and every served result against the same
    requests served on the CPU (``tolerance``'s fraud limits: the stddev's
    sqrt and divisions may differ by an ulp between card and CPU)."""
    from repro_torch.serve import build_service
    out = {}
    for batch in SERVE_BATCHES:
        calls = int(np.clip(SERVE_EVENTS // (batch * 200), 10, 200))
        box = {}
        shapes = record_shapes(lambda: box.update(svc=build_service(
            _serve_fraud(), out_len=batch, segs_per_chunk=1,
            cache_dir=f"{tmp}/b{batch}")))
        svc = box["svc"]
        hold_shapes(dev, errs, f"serve fraud batch {batch}", shapes)
        vals = np.random.default_rng(5).integers(
            0, 100, batch * (calls + SERVE_WARMUP)).astype(np.float32)
        gen = svc.serve(_host_requests(vals, batch))
        served = [next(gen) for _ in range(SERVE_WARMUP)]
        (dts, rest), dt = drive(main_launches,
                                lambda: _steady(svc, gen, calls))
        served += rest
        audit = audit_cell(f"serve fraud batch {batch}", svc.runner)
        cpu = build_service(_serve_fraud(), out_len=batch, segs_per_chunk=1,
                            device="cpu")
        want = [cpu.step(r) for r in _host_requests(vals, batch)]
        stats = compare("fraud", _joined(served), _joined(want))
        p50, p99 = np.percentile(dts, (50, 99))
        out[f"batch_{batch}"] = {
            "batch": batch, "calls": calls, "p50_ms": p50 * 1e3,
            "p99_ms": p99 * 1e3, "events_per_s_p50": batch / p50,
            "captures": svc.runner.metrics.tracer.captures(),
            "vs_cpu": stats, "audit": audit,
            "held_shapes": {k: len(v) for k, v in shapes.items()}}
        log(f"serve fraud batch {batch:4d}: p50 {p50 * 1e3:.4f} ms, p99 "
            f"{p99 * 1e3:.4f} ms per call over {calls} calls "
            f"({batch / p50:.4g} events/s at p50); steady state: no "
            f"synchronizing call, no capture; {len(served)} results vs cpu "
            f"max diff {stats['max_abs_diff']:.3g}, {stats['flips']} gate "
            f"flips; audit={audit}")
    return out


def first_result_main(cache_dir: str) -> int:
    """``--first-result DIR``: one fresh process building the served fraud
    query over ``DIR`` and serving one request; prints the time from
    construction to the first blocked result and the plan's source."""
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.serve import build_service
    t0 = time.perf_counter()
    svc = build_service(_serve_fraud(), out_len=FIRST_RESULT_BATCH,
                        segs_per_chunk=1, cache_dir=cache_dir)
    vals = np.random.default_rng(5).integers(
        0, 100, FIRST_RESULT_BATCH).astype(np.float32)
    next(svc.serve(_host_requests(vals, FIRST_RESULT_BATCH)))
    t1 = time.perf_counter()
    print(json.dumps({"first_result_s": t1 - t0,
                      "since_start_s": t1 - t_start,
                      "plan": svc.plan_source,
                      "captures": sum(svc.runner.metrics.tracer
                                      .captures().values())}))
    return 0


def serve_first_result(tmp: str) -> dict:
    """Cold and warm first result: two fresh subprocesses over one empty
    cache directory, one after the other."""
    out = {}
    for want in ("cold", "warm"):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                              "--first-result", f"{tmp}/first"],
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"first-result process: {res.stderr}")
        doc = json.loads(res.stdout.strip().splitlines()[-1])
        if doc["plan"] != want:
            raise AssertionError(f"expected a {want} start, got {doc}")
        doc["process_s"] = wall
        out[want] = doc
        log(f"serve first result {want}: {doc['first_result_s']:.3f} s from "
            f"construction ({doc['since_start_s']:.3f} s from the start of "
            f"the process, {wall:.3f} s with the interpreter), "
            f"plan={doc['plan']}, {doc['captures']} graphs captured")
    return out


def serve_keyed(dev, main_launches: dict, errs: dict) -> dict:
    """Keyed fraud served at phase 6's full width (16384 keys, 64-tick
    segments, 2 per chunk), sparse at 1% and 100% of the keys active: the
    steady state makes no synchronizing call, and the served outputs equal
    ``Runner.run`` on the same chunks bit for bit."""
    import torch
    from repro_torch.core import compile as qc
    from repro_torch.data import streams
    from repro_torch.engine import ExecPolicy, Runner
    from repro_torch.serve import build_service
    span, T = RK_SEG * RK_SPC, RK_SEG * RK_SPC * RK_CHUNKS
    q = streams.fraud_query(FRAUD_WINDOW, keyed=True)
    policy = ExecPolicy(body="sparse", keys="vmapped")
    out = {}
    for rate in (0.01, 1.0):
        vals = streams.keyed_activity(RK_KEYS, T, rate, 0)
        box = {}
        shapes = record_shapes(lambda: box.update(svc=build_service(
            q, out_len=RK_SEG, policy=policy, n_keys=RK_KEYS,
            segs_per_chunk=RK_SPC)))
        svc = box["svc"]
        hold_shapes(dev, errs, f"serve keyed fraud {rate:.0%}", shapes)
        gen = svc.serve(_host_requests(vals, span))
        served = [next(gen) for _ in range(SERVE_WARMUP)]
        (dts, rest), dt = drive(main_launches, lambda: _steady(
            svc, gen, RK_CHUNKS - SERVE_WARMUP))
        served += rest
        audit = audit_cell(f"serve keyed fraud {rate:.0%}", svc.runner)
        want = Runner(qc.compile_query(q.node, out_len=RK_SEG, sparse=True),
                      policy, n_keys=RK_KEYS, segs_per_chunk=RK_SPC).run(
            {"in": _grid(vals, dev)}, RK_CHUNKS)
        got = want.replace(value=torch.cat([o.value for o in served], -1),
                           valid=torch.cat([o.valid for o in served], -1))
        if not _same_bits(got, want):
            raise AssertionError(f"served keyed fraud at {rate:.0%} != "
                                 "Runner.run")
        st = svc.runner.dirty_stats()
        p50, p99 = np.percentile(dts, (50, 99))
        out[f"rate_{rate:g}"] = {"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
                                 "events_per_s_p50": RK_KEYS * span / p50,
                                 "dirty_fraction": st["compact"],
                                 "audit": audit}
        log(f"serve keyed fraud {RK_KEYS} keys, {rate:.0%} active: p50 "
            f"{p50 * 1e3:.4f} ms, p99 {p99 * 1e3:.4f} ms per chunk "
            f"({RK_KEYS * span / p50:.4g} events/s at p50), dirty fraction "
            f"{st['compact']:.4f}; no synchronizing call, no capture in the "
            f"steady state; equal to Runner.run bit for bit; audit={audit}")
    return out


def serve_events(dev, main_launches: dict, errs: dict) -> dict:
    """The event path over phase 9's ``fig_ooo`` setup (late 0.1,
    lateness 16, 3-chunk horizon, revise): every event offered to the
    admission ring, pumped every ``OOO_POLL`` events, sealed and revised
    chunks staged to the card by the loop; sealed outputs with the
    corrections laid over them equal in-order execution bit for bit, and
    no graph is captured after the loop warmed up."""
    import torch
    from repro_torch.core import compile as qc
    from repro_torch.core.frontend import TStream
    from repro_torch.data import streams
    from repro_torch.engine import ExecPolicy, Runner
    from repro_torch.serve import build_service
    s = TStream.source("in", prec=1)
    q = s.window(32).mean().join(s.window(64).mean(), lambda a, b: a - b)
    vals = streams.burst_stream(OOO_TICKS, 0.05, 5)
    arr = ooo_arrivals(vals, 0.1, 16, np.random.default_rng(17))
    box = {}

    def prepare():
        svc = box["svc"] = build_service(q, out_len=OOO_SEG,
                                         segs_per_chunk=OOO_SPC)
        svc.attach_events(lateness=16, policy="revise",
                          capacity=2 * OOO_POLL, horizon_chunks=3)
        svc.warm()           # the revision buckets, ahead of the first

    shapes = record_shapes(prepare)
    svc = box["svc"]
    hold_shapes(dev, errs, "serve events", shapes)
    tracer = svc.runner.metrics.tracer
    before = tracer.captures()

    def go():
        sealed, corrections = [], []
        for i, (_key, ev) in enumerate(arr):
            if not svc.offer("in", ev):
                raise AssertionError("the admission ring shed an event")
            if i % OOO_POLL == OOO_POLL - 1:
                s_, c_ = svc.pump()
                sealed += s_
                corrections += c_
        s_, c_ = svc.finish()
        return sealed + s_, corrections + c_

    (sealed, corrections), dt = drive(main_launches, go)
    if tracer.captures() != before:
        raise AssertionError("a graph was captured on the event path")
    got_v, got_m = _overlay(sealed, corrections)
    chunk = OOO_SEG * OOO_SPC
    want = Runner(qc.compile_query(q.node, out_len=OOO_SEG, sparse=True),
                  ExecPolicy(body="sparse"), segs_per_chunk=OOO_SPC).run(
        {"in": _grid(vals, dev)}, OOO_TICKS // chunk)
    if not (torch.equal(got_m, want.valid)
            and torch.equal(got_v[got_m], want.value[want.valid])):
        raise AssertionError("served events: sealed + corrections != "
                             "in-order execution")
    audit = audit_cell("serve events", svc.runner)
    c = svc.runner.metrics.snapshot()
    row = {"events": len(arr), "seconds": dt, "audit": audit,
           "events_per_s": len(arr) / dt,
           "corrections": len(corrections), "sealed": len(sealed),
           "admitted": c["counters"]["serve.admitted"]["value"],
           "admit_to_result_p50_s": _quantile(
               svc, "serve.admit_to_result_seconds", 0.5)}
    log(f"serve events (late 0.1, lateness 16): {row['events_per_s']:.4g} "
        f"events/s ({dt:.2f} s), {len(sealed)} sealed chunks, "
        f"{len(corrections)} corrections, admission to sealed result p50 "
        f"{row['admit_to_result_p50_s']}; sealed + corrections equal "
        "in-order execution bit for bit; no capture after warm-up; "
        f"audit={audit}")
    return row


def _quantile(svc, name: str, q: float):
    from repro_torch.obs import Histogram
    h = svc.runner.metrics.get(name)
    return h.quantile(q) if isinstance(h, Histogram) else None


def run_serving(dev, main_launches: dict, errs: dict) -> dict:
    """Phase 10: latency per call, cold and warm first result, keyed
    serving at full width, the event path; each cell's kernel shapes held
    against their plain versions."""
    import tempfile
    (ROOT / "out").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "out") as tmp:
        return {"latency": serve_latency(dev, main_launches, errs, tmp),
                "first_result": serve_first_result(tmp),
                "keyed": serve_keyed(dev, main_launches, errs),
                "events": serve_events(dev, main_launches, errs)}


# ---------------------------------------------------------------------------
# phase 11: mesh placement on a 1-rank NCCL mesh
# ---------------------------------------------------------------------------

def _timed(fn):
    """``fn()`` and its seconds on the host clock, the card finished."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _in_turns(launches: dict, seen: dict, local_fn, mesh_fn,
              rounds: int = 1) -> tuple:
    """One mesh call inside a launch-count window, the shapes its kernels
    are called at recorded into ``seen`` (not timed); then the local call
    and the mesh call timed in turns (local, mesh, mesh, local), ``rounds``
    times.  Returns both results and the smallest time of each."""
    got, _ = drive(launches, recording(seen, mesh_fn))
    want, tl = _timed(local_fn)
    tls, tms = [tl], []
    for r in range(rounds):
        if r:
            tls.append(_timed(local_fn)[1])
        tms += [_timed(mesh_fn)[1], _timed(mesh_fn)[1]]
        tls.append(_timed(local_fn)[1])
    return want, got, min(tls), min(tms)


def mesh_one_shot(dev, mesh, launches: dict, seen: dict) -> dict:
    """``shard_map_run`` against ``partition_run(..., n_parts=1)``."""
    from repro_torch.core import compile as qc
    from repro_torch.core.parallel import partition_run, shard_map_run
    from repro_torch.data import apps as A
    from repro_torch.data import streams
    n = N_TICKS
    trend = A.make_app("trend")
    data = trend.make_input(n, 0)
    for d in data.values():
        d["value"] = np.floor(d["value"])        # integer prices
    cells = [("trend", trend.query.node, A.make_grids(data, device=dev),
              "block"),
             ("fraud", streams.fraud_query(FRAUD_WINDOW).node,
              streams.burst_grids(n, 0.01, 0, device=dev), "block"),
             ("fraud soe", streams.fraud_query(FRAUD_WINDOW).node,
              streams.burst_grids(n, 0.01, 0, device=dev), "soe")]
    out = {}
    for name, q, grids, algo in cells:
        for sparse in (False, True):
            exe, eager = (qc.compile_query(q, out_len=n, sparse=sparse,
                                           sum_algo=algo, jit=jit)
                          for jit in (True, False))
            # the first use of each is not timed
            recording(seen, lambda: shard_map_run(exe, grids, mesh))()
            partition_run(exe, grids, 0, 1)
            want, got, tl, tm = _in_turns(
                launches, seen, lambda: partition_run(exe, grids, 0, 1),
                lambda: shard_map_run(exe, grids, mesh))
            label = f"{name} {'sparse' if sparse else 'dense'}"
            if not _same_bits(want, got):
                raise AssertionError(f"mesh shard_map_run {label} != "
                                     "partition_run")
            log(f"mesh shard_map_run {label} 2**24: {tm * 1e3:.3f} ms "
                f"against partition_run {tl * 1e3:.3f} ms (mesh - local "
                f"{(tm - tl) * 1e3:+.3f} ms); equal bit for bit")
            hold_bits(f"mesh shard_map_run {label}",
                      lambda: shard_map_run(exe, grids, mesh),
                      lambda: shard_map_run(eager, grids, mesh))
            vs = staged_against_eager(
                f"shard_map_run {label}",
                lambda: shard_map_run(exe, grids, mesh),
                lambda: shard_map_run(eager, grids, mesh), 1, replays=1)
            out[label] = {"ms": tm * 1e3, "local_ms": tl * 1e3,
                          "staged": vs}
    return out


def mesh_union(dev, mesh, launches: dict, seen: dict) -> dict:
    """``shard_union_run`` of phase 8's dashboard queries against the
    session over the same span, on integer prices."""
    import torch
    from repro_torch.data import apps as A
    from repro_torch.multiquery import shard_union_run
    rng = np.random.default_rng(7)
    vals = np.floor(rng.random(MQ_TICKS) * 16).astype(np.float32)
    grids = {"in": _grid(vals, dev)}
    qs = A.dashboard_queries(MQ_QUERIES)
    sess = _dash_session(qs, MQ_TICKS, 1, False)
    sess.run(grids, 1)                                 # first use
    recording(seen, lambda: shard_union_run(qs, MQ_TICKS, grids, mesh))()
    # three rounds: the union's capture (its first use) empties the
    # caching allocator (torch.cuda.graph), and the session's outputs then
    # find no free block until a round has freed some (on an H100, a
    # session chunk that allocated its 34 blocks anew took 21.8 ms against
    # 8.0: tools/session_yardstick.py)
    want, got, tl, tm = _in_turns(
        launches, seen, lambda: (sess.reset(), sess.run(grids, 1))[1],
        lambda: shard_union_run(qs, MQ_TICKS, grids, mesh), rounds=3)
    if not _same_heads(want, got):
        raise AssertionError("mesh shard_union_run != session")
    # the staged union and the session's chunk are one captured graph
    # each: the busy time and idle share say how much is dispatch
    prof = device_profile(lambda: shard_union_run(qs, MQ_TICKS, grids, mesh),
                          tm)
    log(f"mesh shard_union_run, {MQ_QUERIES} dashboard queries over 2**24 "
        f"ticks: {tm * 1e3:.3f} ms against the session's one chunk "
        f"{tl * 1e3:.3f} ms (mesh - local {(tm - tl) * 1e3:+.3f} ms); "
        f"every head equal bit for bit; allocator "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    log(f"  one call: {_profile_text(prof)}")
    # always staged (the eager union of the parent commit is timed beside
    # it by tools/one_shot_ab.py): a steady call replays one graph and
    # makes no synchronizing call
    from repro_torch.engine import capture
    r0 = capture.replays["graph"]
    syncs = count_syncs(lambda: shard_union_run(qs, MQ_TICKS, grids, mesh))
    replays = capture.replays["graph"] - r0
    span = _span_ms(lambda: shard_union_run(qs, MQ_TICKS, grids, mesh))
    log(f"  shard_union_run: {syncs} syncs, {replays} replays, span "
        f"{span:.4f} ms a call")
    if syncs or replays != 1:
        raise AssertionError(f"shard_union_run: a steady call made {syncs} "
                             f"synchronizing calls and {replays} replays "
                             "(want 0 and 1)")
    return {"ms": tm * 1e3, "local_ms": tl * 1e3, "profile": prof,
            "syncs": syncs, "replays": replays, "span_ms": span}


def mesh_runner_cell(dev, mesh, launches: dict, seen: dict, label: str,
                     query, grids: dict, n_keys: int, seg: int, spc: int,
                     n_chunks: int, body: str) -> dict:
    """One runner cell at ``placement=mesh`` beside the local runner over
    the same chunks: both captured ahead, timed in turns; equal bit for
    bit; a steady mesh chunk makes no synchronizing call and captures
    nothing; one steady chunk of each profiled."""
    from repro_torch.core import compile as qc
    from repro_torch.engine import ExecPolicy, Runner, mesh_placement
    from repro_torch.serve import aot_capture
    keys = "vmapped" if n_keys > 1 else "single"
    kw = dict(n_keys=n_keys if n_keys > 1 else None, segs_per_chunk=spc)
    span = seg * spc
    exe = qc.compile_query(query, out_len=seg, sparse=body == "sparse")
    local = Runner(exe, ExecPolicy(body=body, keys=keys), **kw)
    meshr = Runner(exe, ExecPolicy(body=body, keys=keys,
                                   placement=mesh_placement(mesh)), **kw)
    aot_capture(local, chunks=_chunk(grids, 0, span))
    drive(launches, recording(seen, lambda: aot_capture(
        meshr, chunks=_chunk(grids, 0, span))))
    caps = dict(meshr.metrics.tracer.captures())

    def again(r):
        r.reset()
        return r.run(grids, n_chunks)

    want, got, tl, tm = _in_turns(launches, seen, lambda: again(local),
                                  lambda: again(meshr))
    if not _same_bits(want, got):
        raise AssertionError(f"mesh runner {label} {body} != local")
    del want, got
    prof = {}
    for name, r in (("local", local), ("mesh", meshr)):
        r.reset()
        r.step(_chunk(grids, 0, span))
        # a first profile of this runner's replays is thrown away (one
        # such first profile on an H100 reported a replay without its
        # kernels)
        device_profile(lambda: r.step(_chunk(grids, 1, span)), 1.0)
        prof[name] = device_profile(lambda: r.step(_chunk(grids, 2, span)),
                                    (tl if name == "local" else tm)
                                    / n_chunks)
    syncs = count_syncs(lambda: meshr.step(_chunk(grids, 3, span)))
    if syncs:
        raise AssertionError(f"mesh runner {label} {body}: a steady chunk "
                             f"made {syncs} synchronizing calls")
    if meshr.metrics.tracer.captures() != caps:
        raise AssertionError(f"mesh runner {label} {body}: captured after "
                             f"warm-up ({caps} -> "
                             f"{meshr.metrics.tracer.captures()})")
    ms, ms_l = tm / n_chunks * 1e3, tl / n_chunks * 1e3
    audit = audit_cell(f"mesh runner {label} {body}", meshr)
    log(f"mesh runner {label} {body:6s}: {ms:.3f} ms per chunk against "
        f"local {ms_l:.3f} ms (mesh - local {ms - ms_l:+.3f} ms); equal "
        f"bit for bit; host reads per steady chunk {syncs}; no capture "
        f"after warm-up; audit={audit}")
    log(f"  one chunk, mesh: {_profile_text(prof['mesh'])}")
    log(f"  one chunk, local: {_profile_text(prof['local'])}")
    return {"ms_per_chunk": ms, "local_ms_per_chunk": ms_l,
            "host_reads_per_chunk": syncs, "chunks": n_chunks,
            "profile": prof["mesh"], "local_profile": prof["local"],
            "audit": audit}


def mesh_runners(dev, mesh, launches: dict, seen: dict) -> dict:
    from repro_torch.data import streams
    out = {}
    n = RUN_SEG * RUN_SPC * RUN_CHUNKS
    grids = {"in": _grid(streams.burst_stream(n, 0.01, 0), dev)}
    out["fraud_single_sparse"] = mesh_runner_cell(
        dev, mesh, launches, seen, "fraud 2**24", streams.fraud_query(
            FRAUD_WINDOW).node, grids, 1, RUN_SEG, RUN_SPC, RUN_CHUNKS,
        "sparse")
    del grids
    T = RK_SEG * RK_SPC * RK_CHUNKS
    for rate in (0.01, 1.0):
        grids = {"in": _grid(streams.keyed_activity(RK_KEYS, T, rate, 0),
                             dev)}
        for body in ("dense", "sparse"):
            out[f"fraud_keyed_{rate:g}_{body}"] = mesh_runner_cell(
                dev, mesh, launches, seen, f"keyed fraud {RK_KEYS} keys, "
                f"{rate:.0%} active", streams.fraud_query(
                    FRAUD_WINDOW, keyed=True).node, grids, RK_KEYS, RK_SEG,
                RK_SPC, RK_CHUNKS, body)
        del grids
    return out


def mesh_keyed(dev, mesh, launches: dict, seen: dict) -> dict:
    """``KeyedEngine(mesh=)`` at phase 6's width and phase 8's keyed
    session with ``mesh=`` (1% active, sparse), on integer prices, against
    their local counterparts."""
    import warnings
    from repro_torch.core import compile as qc
    from repro_torch.data import apps as A
    from repro_torch.data import streams
    from repro_torch.engine import KeyedEngine
    from repro_torch.multiquery import MultiQuerySession
    out = {}
    T = RK_SEG * RK_SPC * RK_CHUNKS
    grids = {"in": _grid(streams.keyed_activity(RK_KEYS, T, 0.01, 0), dev)}
    exe = qc.compile_query(streams.fraud_query(FRAUD_WINDOW,
                                               keyed=True).node,
                           out_len=RK_SEG * RK_SPC, sparse=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        local = KeyedEngine(exe, n_keys=RK_KEYS, sparse=True)
        meshe = KeyedEngine(exe, n_keys=RK_KEYS, sparse=True, mesh=mesh)
    n_parts = T // (RK_SEG * RK_SPC)
    local.run(grids, n_parts)                    # first use
    drive(launches, recording(seen, lambda: (meshe.run(grids, n_parts),
                                             meshe.reset())))
    want, got, tl, tm = _in_turns(
        launches, seen,
        lambda: (local.reset(), local.run(grids, n_parts))[1],
        lambda: (meshe.reset(), meshe.run(grids, n_parts))[1])
    if not _same_bits(want, got):
        raise AssertionError("mesh KeyedEngine != local")
    audit = audit_cell("mesh KeyedEngine", meshe._runner)
    out["keyed_engine"] = {"ms_per_chunk": tm / n_parts * 1e3,
                           "local_ms_per_chunk": tl / n_parts * 1e3,
                           "audit": audit}
    log(f"mesh KeyedEngine {RK_KEYS} keys, 1% active, sparse: "
        f"{tm / n_parts * 1e3:.3f} ms per chunk against local "
        f"{tl / n_parts * 1e3:.3f} ms (mesh - local "
        f"{(tm - tl) / n_parts * 1e3:+.3f} ms); equal bit for bit; "
        f"audit={audit}")
    del grids, want, got
    rng = np.random.default_rng(7)
    vals = np.floor(rng.random((MQ_KEYS, MQ_KEY_TICKS)) * 16).astype(
        np.float32)
    vals = held_keys(vals, 0.01, 0)
    grids = {"in": _grid(vals, dev)}
    n_chunks = MQ_KEY_TICKS // MQ_KEY_SPAN
    qs = A.dashboard_queries(MQ_QUERIES, keyed=True)
    sessions = []
    for m in (None, mesh):
        sess = MultiQuerySession(MQ_KEY_SPAN, n_keys=MQ_KEYS, sparse=True,
                                 mesh=m)
        for name, q in qs.items():
            sess.attach(name, q)
        recording(seen, lambda: sess.prepare(_chunk(grids, 0,
                                                    MQ_KEY_SPAN)))()
        sessions.append(sess)
    want, got, tl, tm = _in_turns(
        launches, seen,
        lambda: (sessions[0].reset(), sessions[0].run(grids, n_chunks))[1],
        lambda: (sessions[1].reset(), sessions[1].run(grids, n_chunks))[1])
    if not _same_heads(want, got):
        raise AssertionError("mesh keyed session != local")
    sessions[1].reset()
    for c in range(2):
        sessions[1].step(_chunk(grids, c, MQ_KEY_SPAN))
    syncs = count_syncs(lambda: sessions[1].step(_chunk(grids, 2,
                                                        MQ_KEY_SPAN)))
    if syncs:
        raise AssertionError(f"mesh keyed session: a steady chunk made "
                             f"{syncs} synchronizing calls")
    ms, ms_l = tm / n_chunks * 1e3, tl / n_chunks * 1e3
    audit = audit_cell("mesh keyed session", sessions[1].runner)
    out["keyed_session"] = {"ms_per_chunk": ms, "local_ms_per_chunk": ms_l,
                            "host_reads_per_chunk": syncs, "audit": audit}
    log(f"mesh keyed session {MQ_QUERIES} queries, {MQ_KEYS} keys, 1% "
        f"active, sparse, integer prices: {ms:.3f} ms per chunk against "
        f"local {ms_l:.3f} ms (mesh - local {ms - ms_l:+.3f} ms); every "
        f"head equal bit for bit; host reads per steady chunk {syncs}; "
        f"audit={audit}")
    return out


def run_mesh(dev, main_launches: dict, errs: dict) -> dict:
    """Phase 11: every mesh-placed entry point on the 1-rank NCCL mesh,
    held against its local counterpart; every shape the phase called a
    kernel at (warm-ups, captures and the launch-count windows recorded)
    held against the kernel's plain version.  The group stays up for
    phase 12."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    t0 = time.perf_counter()
    mesh = make_local_mesh()
    made = time.perf_counter() - t0
    nccl = ".".join(str(x) for x in torch.cuda.nccl.version())
    log(f"mesh {mesh} over {dist.get_backend()} (NCCL {nccl}), "
        f"{dist.get_world_size()} rank, torch.cuda.device_count() "
        f"{torch.cuda.device_count()}; made and warmed in {made:.2f} s")
    launches, seen = {}, {}
    out = {"nccl": nccl, "device_count": torch.cuda.device_count(),
           "mesh_seconds": made,
           "one_shot": mesh_one_shot(dev, mesh, launches, seen),
           "union": mesh_union(dev, mesh, launches, seen),
           "runner": mesh_runners(dev, mesh, launches, seen)}
    out.update(mesh_keyed(dev, mesh, launches, seen))
    hold_shapes(dev, errs, "mesh", record_shapes(lambda: None, seen))
    for k, n in launches.items():
        main_launches[k] = main_launches.get(k, 0) + n
    for k in ("sliding_assoc", "seg_dirty", "prefix_scan"):
        if not launches.get(k, 0):
            raise AssertionError(f"{k} was never launched in the mesh phase")
    log("mesh phase launches: " + ", ".join(
        f"{k} {n}" for k, n in launches.items() if n))
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 12: the static audit on the card
# ---------------------------------------------------------------------------

def _severities(findings) -> str:
    n = {}
    for f in findings:
        n[f.severity] = n.get(f.severity, 0) + 1
    return "/".join(f"{k[0]}{v}" for k, v in sorted(n.items())) or "-"


def audit_lattice_on_card(dev, seen: dict) -> dict:
    """12(a): every pass over every point of the 16-point lattice, each
    point's runner built at the audit's small geometry; its kernels'
    shapes recorded into ``seen``."""
    from repro_torch.analysis import (PASSES, build_lattice_runner,
                                      lattice_policies, make_target,
                                      verdict)
    out = {}
    for policy in lattice_policies(dev):
        label = policy.describe()
        t0 = time.perf_counter()
        target = make_target(build_lattice_runner(policy), device=dev)
        by_pass = recording(seen, lambda: {
            name: fn(target) for name, fn in PASSES.items()})()
        dt = time.perf_counter() - t0
        flat = [f for fs in by_pass.values() for f in fs]
        v = verdict(flat)
        out[label] = {"verdict": v, "seconds": dt,
                      "by_pass": {k: _severities(fs)
                                  for k, fs in by_pass.items()},
                      "findings": [f.to_json() for f in flat
                                   if f.severity != "info"]}
        log(f"audit {label:26s} " + " ".join(
            f"{k} {_severities(fs)}" for k, fs in by_pass.items())
            + f"; verdict {v}; {dt:.2f} s")
        _log_findings("audit", flat)
        if v == "error":
            raise AssertionError(f"lattice point {label}: error findings: "
                                 + "; ".join(f"{f.code} @ {f.provenance}"
                                             for f in flat
                                             if f.severity == "error"))
    return out


def audit_corpus_on_card(dev, seen: dict) -> dict:
    """12(b): each known-bad fixture of ``tests/test_torch_analysis.py``
    (imports neither jax nor the reference) fires its code on the card,
    and a full audit of the shipped runner at the fixture's point has no
    error and no warning but the documented mesh-sparse one."""
    from repro_torch.launch.mesh import make_local_mesh
    sys.path.insert(0, str(ROOT / "tests"))
    import test_torch_analysis as corpus
    mesh = make_local_mesh()            # phase 11's group, reused
    out = {}
    for name, (_fn, code, _build) in corpus.CORPUS.items():
        t0 = time.perf_counter()
        fired = recording(seen, lambda: corpus.corpus_findings(
            name, dev, mesh))()
        hits = [f for f in fired if f.code == code]
        if not hits:
            raise AssertionError(f"corpus {name}: {code} did not fire on "
                                 f"the card ({[f.code for f in fired]})")
        noise = recording(seen, lambda: corpus.shipped_noise(
            name, dev, mesh))()
        if noise:
            raise AssertionError(f"corpus {name}: the shipped runner is "
                                 f"not clean: {[f.code for f in noise]}")
        dt = time.perf_counter() - t0
        out[name] = {"code": code, "hits": len(hits), "seconds": dt,
                     "provenance": hits[0].provenance}
        log(f"audit corpus {name}: {code} fired {len(hits)}x on the card "
            f"(@ {hits[0].provenance or hits[0].target}); the shipped "
            f"runner at its point is clean; {dt:.2f} s")
    return out


def run_audit(dev, errs: dict) -> dict:
    """Phase 12: the lattice (a) and the corpus (b) on the card, the cell
    audits of phases 5-11 (c) summed, every kernel shape the audits
    launched held against the plain versions (d)."""
    t0 = time.perf_counter()
    seen = AUDITS["shapes"]
    lattice = audit_lattice_on_card(dev, seen)
    t1 = time.perf_counter()
    corpus = audit_corpus_on_card(dev, seen)
    t2 = time.perf_counter()
    hold_shapes(dev, errs, "audit", record_shapes(lambda: None, seen))
    t3 = time.perf_counter()
    cells = AUDITS["cells"]
    cell_s = sum(c["seconds"] for c in cells.values())
    verdicts = {}
    for c in cells.values():
        verdicts[c["verdict"]] = verdicts.get(c["verdict"], 0) + 1
    log(f"audit: lattice {t1 - t0:.2f} s, corpus {t2 - t1:.2f} s, shape "
        f"holds {t3 - t2:.2f} s; {len(cells)} cell audits of phases 5-11 "
        f"{cell_s:.2f} s ({verdicts}); added {t3 - t0 + cell_s:.2f} s")
    return {"lattice": lattice, "corpus": corpus, "cells": cells,
            "seconds": {"lattice": t1 - t0, "corpus": t2 - t1,
                        "holds": t3 - t2, "cells": cell_s,
                        "added": t3 - t0 + cell_s}}


# ---------------------------------------------------------------------------
# phase 13: LM serving (repro_torch.launch.serve)
# ---------------------------------------------------------------------------

LM_SEED = 20
LM_REL_TOL = 2e-2   # bf16: max|a - b| <= tol * (max|b| + |b|)
LM_F32_TOL = 1e-4   # f32: |a - b| <= tol * (1 + |b|), TF32 off
# 13(a): qwen3-1.7b at full width and depth
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_REQUESTS = (
    "qwen3-1.7b", 32, 1024, 128, 64)
# 13(b): (arch, depth cut, prompt, length of the consistency sequence)
LM_FAMILIES = (
    ("gemma2-2b", {"n_layers": 2}, 5120, 6144),
    ("granite-moe-1b-a400m", {"n_layers": 2}, 1024, 1056),
    ("recurrentgemma-9b", {"n_layers": 3}, 3072, 4096),
    ("rwkv6-7b", {"n_layers": 2}, 64, 128),
    ("whisper-large-v3", {"n_layers": 2, "n_enc_layers": 2}, 64, 128),
)
LM_FAM_BATCH, LM_FAM_GEN, LM_FAM_REQUESTS = 4, 32, 8


def _lm_model(arch: str, cut: dict, dev, **over):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), **cut, **over)
    return build_model(cfg, device=dev)


def _lm_frames(cfg, B: int, dev, seed: int):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((B, cfg.enc_seq, cfg.d_model), generator=g,
                       device=dev)


def lm_consistency(model, params, tokens: np.ndarray, prompt: int,
                   frames=None) -> float:
    """Decode against a full forward at the same positions: the requests
    of ``tokens`` (B, T) prefilled over their first ``prompt`` tokens, then
    decoded teacher-forced over the rest through the serve steps (one
    graph replay a step); the full forward runs each request alone (batch
    1: an MoE group of at most 64 tokens stays dropless).  Returns
    max|decode - full| / max|full| over the prefill's last logits and
    every decode step's."""
    import torch
    from repro_torch.models import encdec, transformer
    from repro_torch.train import make_serve_steps
    cfg, dev = model.cfg, model.device
    toks = torch.from_numpy(tokens.astype(np.int32)).to(dev)
    B, T = toks.shape
    n = T - prompt
    full = []
    for b in range(B):
        if cfg.family == "encdec":
            enc = encdec.forward_encoder(params, cfg, frames[b:b + 1])
            lg, _ = encdec._decoder(params, cfg, toks[b:b + 1], enc,
                                    last=n + 1)
        else:
            lg, _, _ = transformer.forward(params, cfg, toks[b:b + 1],
                                           last=n + 1)
        full.append(lg)
    full = torch.cat(full)              # positions prompt-1 .. T-1
    prefill_fn, decode_fn = make_serve_steps(model)
    if cfg.family == "encdec":
        logits, caches, enc = prefill_fn(params, toks[:, :prompt],
                                         frames[:B], max_len=T)
        rest = (enc,)
    else:
        logits, caches = prefill_fn(params, toks[:, :prompt], max_len=T)
        rest = ()
    err = (logits[:, 0] - full[:, 0]).abs().amax()
    pos = torch.full((), prompt, dtype=torch.int32, device=dev)
    for i in range(n):
        lg, caches = decode_fn(params, caches,
                               toks[:, prompt + i:prompt + i + 1], pos, *rest)
        err = torch.maximum(err, (lg[:, 0] - full[:, i + 1]).abs().amax())
        pos.add_(1)
    rel = float(err / full.abs().amax())
    if not np.isfinite(rel):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return rel


def lm_decode_bound_ms(params, caches) -> tuple:
    """(bytes, ms): every weight and every cache buffer read once (a
    global layer's decode reads its whole cache), over the memory rate."""
    import torch
    from repro_torch.models.layers import KVCache
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    for st in caches:
        leaves = (st.k, st.v) if isinstance(st, KVCache) else st.values()
        nbytes += sum(t.numel() * t.element_size() for t in leaves
                      if torch.is_tensor(t))
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def lm_serve_cell(label: str, model, params, batch: int, prompt: int,
                  gen: int, n_req: int, seed: int, frames=None) -> dict:
    """Requests drawn from ``seed`` served through ``serve_waves``: one
    wave first (it captures the decode graph), then the timed run over
    all of them with the same steps; then, after a fresh prefill, step t's
    logits held across step t+1 (they must not change), and a steady
    decode step alone at position ``prompt + gen // 2``: its
    synchronizing calls (0, and none under the sync debug mode set to
    raise), its host time and its device busy time and idle share."""
    import torch
    from repro_torch.launch.serve import serve_waves
    from repro_torch.models import encdec
    from repro_torch.train import make_serve_steps
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    reqs = list(rng.integers(0, cfg.vocab, (n_req, prompt)))
    steps = make_serve_steps(model)
    serve_waves(model, params, reqs[:batch], batch, prompt, gen, frames,
                steps=steps)
    torch.cuda.synchronize()
    stats: dict = {}
    t0 = time.perf_counter()
    done = serve_waves(model, params, reqs, batch, prompt, gen, frames,
                       stats=stats, steps=steps)
    wall = time.perf_counter() - t0
    if len(done) != n_req or any(len(d) != gen for d in done):
        raise AssertionError(f"{label}: {len(done)} answers")
    if not all(0 <= t < cfg.vocab_padded for d in done for t in d):
        raise AssertionError(f"{label}: a token out of the vocabulary")
    prefill_fn, decode_fn = steps
    if len(decode_fn.graphs) != 1:
        raise AssertionError(f"{label}: {len(decode_fn.graphs)} decode "
                             "graphs for one (batch, max_len)")
    prompt_toks = torch.from_numpy(np.stack(reqs[:batch]).astype(
        np.int32)).to(dev)
    if cfg.family == "encdec":
        _, caches, enc = prefill_fn(params, prompt_toks, frames,
                                    max_len=prompt + gen)
        rest = (enc,)
    else:
        _, caches = prefill_fn(params, prompt_toks, max_len=prompt + gen)
        rest = ()
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
    pos = torch.full((), prompt, dtype=torch.int32, device=dev)
    # C13: logits held from step t are not rewritten by step t+1
    held, _ = decode_fn(params, caches, tok, pos, *rest)
    copy = held.clone()
    pos.add_(1)
    nxt, _ = decode_fn(params, caches, tok, pos, *rest)
    if not torch.equal(held, copy) or torch.equal(held, nxt):
        raise AssertionError(f"{label}: step t's logits changed at t+1")
    if len(decode_fn.graphs) != 1:
        raise AssertionError(f"{label}: the fresh prefill's caches took a "
                             "second decode graph")
    pos.fill_(prompt + gen // 2)    # the steady step is timed mid-answer

    def step():
        lg, _ = decode_fn(params, caches, tok, pos, *rest)
        tok.copy_(torch.argmax(lg[:, 0], dim=-1)[:, None])

    syncs = count_syncs(lambda: [step() for _ in range(10)]) / 10
    if syncs:
        raise AssertionError(f"{label}: {syncs} syncs per decode step")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(50):
        step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / 50
    prof = device_profile(step, step_s)
    dec = np.asarray(stats["decode_ms"])
    bound_bytes, bound = lm_decode_bound_ms(params, caches)
    row = {"tokens_per_s": n_req * gen / wall, "wall_s": wall,
           "held_logits_kept": True,
           "prefill_ms": stats["prefill_ms"],
           "decode_p50_ms": float(np.median(dec)),
           "decode_p99_ms": float(np.quantile(dec, 0.99)),
           "step_ms": step_s * 1e3, "syncs_per_step": syncs,
           "device_ms": prof["device_ms"], "idle_share": prof["idle_share"],
           "top": prof["top"], "bound_bytes": bound_bytes,
           "bound_ms": bound}
    log(f"  {label}: {row['tokens_per_s']:.1f} tok/s ({n_req} requests x "
        f"{gen} tokens, batch {batch}, prompt {prompt}, {wall:.3f} s); "
        f"prefill ms/wave {', '.join(f'{v:.3f}' for v in row['prefill_ms'])}"
        f"; decode ms/step p50 {row['decode_p50_ms']:.4f} p99 "
        f"{row['decode_p99_ms']:.4f} (steady step {row['step_ms']:.4f}, "
        f"device {_ms(row['device_ms'])}, idle {row['idle_share']}); "
        f"syncs/step {syncs:g}; step t's logits kept across step t+1; bound "
        f"{bound:.4f} ms ({bound_bytes} bytes: "
        f"weights + caches read once); top kernels " + ", ".join(
            f"{k} {v:.3f}" for k, v in row["top"]))
    return row


def lm_full_width(dev) -> dict:
    """13(a): qwen3-1.7b at full width and depth through the wave loop."""
    import torch
    model = _lm_model(LM_ARCH, {}, dev)
    cfg = model.cfg
    params = model.init(torch.Generator(device=dev).manual_seed(LM_SEED))
    row = lm_serve_cell(f"{cfg.name} full ({cfg.n_layers} layers)", model,
                        params, LM_BATCH, LM_PROMPT, LM_GEN, LM_REQUESTS,
                        LM_SEED)
    toks = np.random.default_rng(LM_SEED + 1).integers(
        0, cfg.vocab, (2, LM_PROMPT + LM_GEN))
    row["consistency"] = lm_consistency(model, params, toks, LM_PROMPT)
    row["params"] = model.param_count(params)
    log(f"  {cfg.name}: {row['params']} parameters; decode against full "
        f"forward, 2 requests x {LM_GEN} steps: max|d|/max|logit| "
        f"{row['consistency']:.3e} (limit {LM_REL_TOL})")
    if not row["consistency"] <= LM_REL_TOL:
        raise AssertionError(f"{cfg.name}: decode/full {row['consistency']}")
    return row


def lm_families(dev) -> dict:
    """13(b): one configuration of each other family at full width, its
    depth cut, served in batches of 4 and checked for consistency."""
    import torch
    from repro_torch.models.layers import moe_capacity
    out = {}
    for arch, cut, prompt, t_full in LM_FAMILIES:
        model = _lm_model(arch, cut, dev)
        cfg = model.cfg
        params = model.init(torch.Generator(device=dev).manual_seed(
            LM_SEED))
        frames = (_lm_frames(cfg, LM_FAM_BATCH, dev, LM_SEED)
                  if cfg.family == "encdec" else None)
        log(f"  {arch}: depth cut to {cut} (full width d_model "
            f"{cfg.d_model}, vocab {cfg.vocab})")
        row = lm_serve_cell(arch, model, params, LM_FAM_BATCH, prompt,
                            LM_FAM_GEN, LM_FAM_REQUESTS, LM_SEED, frames)
        if cfg.is_moe:
            G, Ng, C = moe_capacity(cfg, LM_FAM_BATCH * prompt)
            row["moe_prefill"] = {"groups": G, "tokens": Ng, "capacity": C,
                                  "dropping": Ng > 64}
            log(f"  {arch}: served prefill groups {G} x {Ng} tokens, "
                f"capacity {C} a expert ({'dropping' if Ng > 64 else 'dropless'})"
                f"; the consistency check runs dropless groups")
        toks = np.random.default_rng(LM_SEED + 1).integers(
            0, cfg.vocab, (2, t_full))
        row["consistency"] = lm_consistency(
            model, params, toks, prompt,
            frames[:2] if frames is not None else None)
        row["cut"] = cut
        log(f"  {arch}: decode against full forward, 2 requests, prompt "
            f"{prompt}, {t_full - prompt} steps: max|d|/max|logit| "
            f"{row['consistency']:.3e}")
        if not row["consistency"] <= LM_REL_TOL:
            raise AssertionError(f"{arch}: decode/full {row['consistency']}")
        out[arch] = row
        del model, params, frames
        torch.cuda.empty_cache()
    return out


def _lm_run(model, params, tokens, frames, steps):
    """Forward logits, then prefill over half the tokens and decode the
    rest teacher-forced; returns every logit tensor and the final caches
    (as numpy, the reference's layout)."""
    import torch
    from repro_torch import convert
    from repro_torch.models import encdec, transformer
    cfg = model.cfg
    B, S = tokens.shape
    half = S // 2
    prefill_fn, decode_fn = steps
    outs = []
    if cfg.family == "encdec":
        enc = encdec.forward_encoder(params, cfg, frames)
        outs.append(encdec._decoder(params, cfg, tokens, enc)[0])
        lg, caches, enc = prefill_fn(params, tokens[:, :half], frames,
                                     max_len=S)
        rest = (enc,)
    else:
        outs.append(transformer.forward(params, cfg, tokens)[0])
        lg, caches = prefill_fn(params, tokens[:, :half], max_len=S)
        rest = ()
    outs.append(lg)
    for t in range(half, S):
        lg, caches = decode_fn(params, caches, tokens[:, t:t + 1], t, *rest)
        outs.append(lg.clone())
    return ([o.float().cpu().numpy() for o in outs],
            convert.lm_cache_to_numpy(cfg, caches))


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: tree}


def lm_smoke_card_cpu(dev) -> dict:
    """13(c): every SMOKE configuration (and qwen3's f8 cache) on the card
    and on the CPU with the same weights: forward logits, prefill logits,
    8 decode steps (a graph replay each on the card) and the caches; bf16
    within ``LM_REL_TOL`` of the largest value, f32 within ``LM_F32_TOL``
    with TF32 off for matmuls and cuDNN."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_steps
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        cases = []
        for arch, (_, smoke) in sorted(registry().items()):
            cases.append((arch, smoke))
            cases.append((f"{arch} f32", dataclasses.replace(
                smoke, dtype="float32", param_dtype="float32")))
        q = registry()["qwen3-1.7b"][1]
        cases.append(("qwen3-1.7b f8 cache", dataclasses.replace(
            q, cache_dtype="float8_e4m3fn")))
        for label, cfg in cases:
            cpu = build_model(cfg, device="cpu")
            card = build_model(cfg, device=dev)
            p_cpu = cpu.init(torch.Generator().manual_seed(LM_SEED))
            p_card = copy.deepcopy(p_cpu).to(dev)
            rng = np.random.default_rng(LM_SEED)
            toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
            fr = (rng.normal(size=(2, cfg.enc_seq, cfg.d_model))
                  .astype(np.float32) if cfg.family == "encdec" else None)
            got = _lm_run(card, p_card, torch.from_numpy(toks).to(dev),
                          None if fr is None else torch.from_numpy(fr).to(dev),
                          make_serve_steps(card))
            want = _lm_run(cpu, p_cpu, torch.from_numpy(toks),
                           None if fr is None else torch.from_numpy(fr),
                           make_serve_steps(cpu))
            pairs = list(zip(got[0], want[0]))
            a, b = _flat(got[1]), _flat(want[1])
            pairs += [(a[k], b[k]) for k in b]
            f32 = cfg.dtype == "float32"
            worst = 0.0
            for g, w in pairs:
                g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
                if f32:
                    r = (np.abs(g - w) / (LM_F32_TOL * (1 + np.abs(w)))).max()
                else:
                    r = (np.abs(g - w) / (LM_REL_TOL * (
                        np.abs(w).max() + np.abs(w)) + 1e-30)).max()
                worst = max(worst, float(r))
            out[label] = worst
            if not worst <= 1.0:
                raise AssertionError(f"13(c) {label}: card against CPU at "
                                     f"{worst:.3f} of the limit")
        log("  13(c) card against CPU, share of the limit used: " + ", ".join(
            f"{k} {v:.3f}" for k, v in out.items()))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return out


def run_lm(dev, main_launches: dict) -> dict:
    """Phase 13: LM serving.  No kernel of the TiLT path lies on it (the
    reference's models reach no ``pallas_call``): its launch-count window
    must read 0 for every kernel."""
    import torch
    t0 = time.perf_counter()
    res = {}

    def go():
        res["full"] = lm_full_width(dev)
        torch.cuda.empty_cache()
        res["families"] = lm_families(dev)

    drive(main_launches, go)
    if any(main_launches.values()):
        raise AssertionError(f"a TiLT kernel launched on the LM path: "
                             f"{main_launches}")
    res["smoke"] = lm_smoke_card_cpu(dev)
    res["seconds"] = time.perf_counter() - t0
    log(f"LM serving phase: {res['seconds']:.1f} s")
    return res

# ---------------------------------------------------------------------------
# phase 14: LM training (repro_torch.train, repro_torch.launch.train)
# ---------------------------------------------------------------------------

TRAIN_SEED = 21
BF16_OPS_PER_S = 989e12    # H100 SXM dense bf16 (tensor cores)
# 14(a): qwen3-1.7b at full width and depth, remat on
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen3-1.7b", 8, 1024, 20
TRAIN_F32_LOSS, TRAIN_F32_GRAD = 1e-5, 1e-4    # as the CPU tests
TRAIN_BF16_LOSS, TRAIN_BF16_GRAD = 1e-3, 5e-2
# 14(c): an f32 leaf's bound is at least TRAIN_KAPPA_X times its sensitivity
# (the largest move of TRAIN_KAPPA_DRAWS one-ulp weight perturbations); the
# f64 witness's bound on card against CPU
TRAIN_KAPPA_X, TRAIN_KAPPA_DRAWS, TRAIN_F64 = 3, 8, 1e-10


def train_flops(cfg, n_params: int, B: int, S: int) -> tuple:
    """(model FLOPs of one train step, its attention part): 6 * N * T for
    the parameters' products (forward and backward; N counts the tied
    unembedding once, as it is one product) plus the attention scores and
    their weighted sum, 4 * hd FLOPs a (query, key) pair a head forward,
    3x with the backward.  A causal layer needs the pairs at or before
    each query (within the window for a local layer): that is the
    function's work, though the port forms every score.  Remat's
    recomputed forward is not model work and is not counted."""
    def pairs(kind):
        if kind == "local":
            return sum(min(i + 1, cfg.window) for i in range(S))
        return S * (S + 1) // 2
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    attn = sum(3 * 4 * B * pairs(k) * cfg.n_heads * cfg.hd
               for k in kinds if k in ("global", "local"))
    return 6 * n_params * B * S + attn, attn


def _pool_bytes() -> int:
    """Bytes reserved by CUDA-graph private memory pools."""
    import torch
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def lm_train_full(dev) -> dict:
    """14(a): qwen3-1.7b at full width and depth through ``make_train_step``
    and ``TokenPipeline``: step 1 eager (and the capture), then
    ``TRAIN_STEPS`` timed replays (CUDA events), then a steady step alone:
    its synchronizing calls, its device busy time (``torch.profiler``), the
    graph pool and the peak memory; every step's loss must be finite."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import init_opt_state, make_train_step
    model = _lm_model(TRAIN_ARCH, {}, dev)
    cfg = model.cfg
    params = model.init(torch.Generator(device=dev).manual_seed(TRAIN_SEED))
    opt = init_opt_state(params)
    step_fn = make_train_step(model)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=TRAIN_SEED,
                         device=dev)
    n_params = model.param_count(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, m = step_fn(params, opt, pipe.next())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses = [m["loss"]]
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_STEPS + 1)]
    marks[0].record()
    for i in range(TRAIN_STEPS):
        _, _, m = step_fn(params, opt, pipe.next())
        marks[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    ms = np.asarray([marks[i].elapsed_time(marks[i + 1])
                     for i in range(TRAIN_STEPS)])
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"14(a): a non-finite loss: {losses}")

    def step():
        step_fn(params, opt, pipe.next())

    syncs = count_syncs(lambda: [step() for _ in range(3)]) / 3
    if syncs:
        raise AssertionError(f"14(a): {syncs} syncs per train step")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / 3
    prof = device_profile(step, step_s)
    flops, attn = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    bound = flops / BF16_OPS_PER_S * 1e3
    p50 = float(np.median(ms))
    row = {"params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "first_step_s": first_s, "p50_ms": p50,
           "p99_ms": float(np.quantile(ms, 0.99)),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
           "losses": losses, "syncs_per_step": syncs, "step_ms": step_s * 1e3,
           "device_ms": prof["device_ms"], "idle_share": prof["idle_share"],
           "top": prof["top"], "pool_bytes": _pool_bytes(),
           "max_allocated_bytes": torch.cuda.max_memory_allocated(),
           "flops": flops, "attn_flops": attn, "bound_ms": bound,
           "bound_share": bound / p50}
    log(f"  14(a) {cfg.name} full ({cfg.n_layers} layers, {n_params} "
        f"parameters, remat on), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: "
        f"step 1 (eager + capture) {first_s:.2f} s; {TRAIN_STEPS} replays "
        f"ms/step p50 {p50:.3f} p99 {row['p99_ms']:.3f}; "
        f"{row['tokens_per_s']:.0f} tokens/s; steady step "
        f"{row['step_ms']:.3f} ms, device {_ms(row['device_ms'])}, idle "
        f"{row['idle_share']}; syncs/step {syncs:g}; graph pool "
        f"{row['pool_bytes'] / 2**30:.2f} GiB, max allocated "
        f"{row['max_allocated_bytes'] / 2**30:.2f} GiB; top kernels "
        + ", ".join(f"{k} {v:.3f}" for k, v in row["top"]))
    log(f"  14(a) compute bound: {flops:.4e} model FLOPs a step (6*N*T "
        f"{6 * n_params * TRAIN_BATCH * TRAIN_SEQ:.4e} + attention "
        f"{attn:.4e}, causal pairs only) over {BF16_OPS_PER_S:.3e} bf16 "
        f"FLOP/s = {bound:.3f} ms; share reached {row['bound_share']:.3f} "
        "(remat's recomputed forward, about a third more, and the masked "
        "half of the scores the port forms are work above the model "
        "FLOPs)")
    log("  14(a) losses: " + " ".join(f"{x:.4f}" for x in losses))
    return row


def _train_state(params, opt) -> list:
    return ([p.detach() for p in params.parameters()]
            + list(opt["m"].values()) + list(opt["v"].values())
            + [opt["step"]])


def lm_train_captured_eager(dev) -> dict:
    """14(b): qwen3-1.7b at full width, 2 layers: from one seeded state,
    four eager steps against the captured step (an eager first step and
    its capture, then three replays); losses, parameters and moments
    compared bit for bit."""
    import torch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import init_opt_state, make_train_step
    runs = []
    for _ in range(2):
        model = _lm_model(TRAIN_ARCH, {"n_layers": 2}, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(
            TRAIN_SEED))
        runs.append((model, params, init_opt_state(params),
                     TokenPipeline(model.cfg, TRAIN_BATCH, TRAIN_SEQ,
                                   seed=TRAIN_SEED, device=dev)))
    (me, pe, oe, de), (mg, pg, og, dg) = runs
    eager, captured = make_train_step(me), make_train_step(mg)
    le, lg = [], []
    for _ in range(4):
        le.append(eager.eager(pe, oe, de.next())[2]["loss"])
        lg.append(captured(pg, og, dg.next())[2]["loss"])
    torch.cuda.synchronize()
    loss_d = max(abs(float(a) - float(b)) for a, b in zip(le, lg))
    state_d = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(_train_state(pe, oe), _train_state(pg, og)))
    equal = loss_d == 0 and state_d == 0
    log(f"  14(b) {TRAIN_ARCH} 2 layers, 4 steps: captured against eager "
        f"{'bit for bit' if equal else 'DIFFER'} (largest loss difference "
        f"{loss_d:.3e}, parameter/moment difference {state_d:.3e}); "
        f"losses {' '.join(f'{float(x):.6f}' for x in lg)}")
    if not equal:
        raise AssertionError("14(b): captured and eager train steps differ")
    return {"loss_diff": loss_d, "state_diff": state_d,
            "losses": [float(x) for x in lg]}


def _train_grads(model, params, batch) -> tuple:
    """(loss, gradients on the CPU, in their own dtype)."""
    from repro_torch.train import value_and_grad
    loss, grads = value_and_grad(model, params, batch)
    return float(loss), {k: g.detach().cpu() for k, g in grads.items()}


def _grad_sensitivity(model, params, batch, grads) -> dict:
    """Per gradient leaf, on the CPU: how far a seeded perturbation of every
    weight by one f32 ulp (relative ``EPS32``, normal) moves it, over the
    leaf's largest magnitude; the largest over ``TRAIN_KAPPA_DRAWS`` such
    perturbations.  Two devices that round differently move an
    ill-conditioned gradient about this far."""
    import copy
    import torch
    kappa = {k: 0.0 for k in grads}
    for seed in range(TRAIN_SEED, TRAIN_SEED + TRAIN_KAPPA_DRAWS):
        moved = copy.deepcopy(params)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for t in moved.parameters():
                t.mul_(1 + EPS32 * torch.randn(t.shape, generator=gen))
        _, g2 = _train_grads(model, moved, batch)
        for k, w in grads.items():
            kappa[k] = max(kappa[k], _rel(g2[k], w))
    return kappa


def _rel(got, want) -> float:
    """max |got - want| over max |want|, in f64."""
    want = want.double()
    return (float((got.double() - want).abs().max())
            / (float(want.abs().max()) + 1e-300))


def _f64_grads(model, params, batch) -> tuple:
    """``_train_grads`` with every f32 operation of the step run in f64: the
    f32 parameters are promoted, the default dtype is f64, and a dispatch
    mode turns each f32 dtype argument and f32 tensor argument into f64 and
    refuses an op that would still write or yield f32."""
    import copy
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten, tree_map

    def up(x):
        if x is torch.float32:
            return torch.float64
        if torch.is_tensor(x) and x.dtype == torch.float32:
            return x.double()
        return x

    def f32(tree):
        return any(torch.is_tensor(t) and t.dtype == torch.float32
                   for t in tree_flatten(tree)[0])

    class F64(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func._schema.is_mutable and f32((args, kwargs)):
                raise RuntimeError(f"f64 witness: {func} writes f32")
            out = func(*tree_map(up, args), **tree_map(up, kwargs))
            if f32(out):
                raise RuntimeError(f"f64 witness: {func} yields f32")
            return out

    wide = copy.deepcopy(params)
    for t in wide.parameters():
        t.data = t.data.double()
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)    # factories given no dtype
    try:
        with F64():
            return _train_grads(model, wide, batch)
    finally:
        torch.set_default_dtype(default)


def lm_train_card_cpu(dev) -> dict:
    """14(c): every SMOKE configuration, in its dtype and at f32, one train
    step on the card and on the CPU with the same weights and batch
    (TF32 off): the loss and every gradient within the CPU tests' bounds
    (f32: loss 1e-5 relative, a gradient leaf 1e-4 of its largest
    magnitude; bf16: 1e-3 and 5e-2), an f32 leaf's bound raised to
    ``TRAIN_KAPPA_X`` times its measured sensitivity to one ulp of the
    weights where that is larger (``_grad_sensitivity``: rwkv6's f32
    gradients move up to about 3e-4 under it), then the step itself (eager,
    its capture and one replay on the card) and its losses.  The f32
    variant runs in f64 on both as well (``_f64_grads``): card and CPU
    within ``TRAIN_F64`` of each other, and each one's f32 gradients within
    their bound of that f64 result; the largest f32 error against f64, in
    units of the sensitivity, is printed for each."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import init_opt_state, make_train_step
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, f64_read = {}, {}
    try:
        for arch, (_, smoke) in sorted(registry().items()):
            for label, cfg in ((arch, smoke), (f"{arch} f32",
                               dataclasses.replace(smoke, dtype="float32",
                                                   param_dtype="float32"))):
                f32 = cfg.dtype == "float32"
                tl, tg = ((TRAIN_F32_LOSS, TRAIN_F32_GRAD) if f32 else
                          (TRAIN_BF16_LOSS, TRAIN_BF16_GRAD))
                cpu = build_model(cfg, device="cpu")
                card = build_model(cfg, device=dev)
                p_cpu = cpu.init(torch.Generator().manual_seed(TRAIN_SEED))
                p_card = copy.deepcopy(p_cpu).to(dev)
                batches = [TokenPipeline(cfg, 2, 16, seed=TRAIN_SEED,
                                         device=d) for d in ("cpu", dev)]
                b_cpu, b_card = (bp.next() for bp in batches)
                l_cpu, g_cpu = _train_grads(cpu, p_cpu, b_cpu)
                l_card, g_card = _train_grads(card, p_card, b_card)
                kappa = (_grad_sensitivity(cpu, p_cpu, b_cpu, g_cpu) if f32
                         else dict.fromkeys(g_cpu, 0.0))
                bound = {k: max(tg, TRAIN_KAPPA_X * c)
                         for k, c in kappa.items()}
                parts = {"loss": abs(l_card - l_cpu) / (tl * abs(l_cpu))}
                for k, w in g_cpu.items():
                    parts[k] = _rel(g_card[k], w) / bound[k]
                if f32:
                    l64, g64 = _f64_grads(cpu, p_cpu, b_cpu)
                    l64_card, g64_card = _f64_grads(card, p_card, b_card)
                    wide = max([abs(l64_card - l64) / abs(l64)]
                               + [_rel(g64_card[k], w)
                                  for k, w in g64.items()])
                    parts["f64 card against CPU"] = wide / TRAIN_F64
                    units = {}
                    for side, g in (("card", g_card), ("cpu", g_cpu)):
                        rel = {k: _rel(g[k], w) for k, w in g64.items()}
                        for k, e in rel.items():
                            parts[f"{side} f32 against f64 {k}"] = (
                                e / bound[k])
                        units[side] = max(rel[k] / kappa[k] for k in rel)
                    f64_read[label] = (wide, units["card"], units["cpu"])
                steps = []
                for model, params, bp, b0 in ((cpu, p_cpu, batches[0], b_cpu),
                                              (card, p_card, batches[1],
                                               b_card)):
                    fn, opt = make_train_step(model), init_opt_state(params)
                    steps.append([float(fn(params, opt, b)[2]["loss"])
                                  for b in (b0, bp.next(), bp.next())])
                # later steps: after AdamW's first update (about sign(g)
                # times the learning rate) held as a gradient leaf is
                for i, (a, b) in enumerate(zip(*steps)):
                    parts[f"step {i + 1} loss"] = abs(a - b) / (tg * abs(b))
                what = max(parts, key=parts.get)
                out[label] = (parts[what], what, max(kappa.values()))
                if not parts[what] <= 1.0:
                    raise AssertionError(f"14(c) {label}: card against CPU "
                                         f"at {parts[what]:.3f} of the "
                                         f"limit ({what})")
        log("  14(c) train step, card against CPU, share of the limit "
            "used (where; the largest gradient sensitivity): " + ", ".join(
                f"{k} {v:.3f} ({w}; {c:.1e})" for k, (v, w, c) in out.items()))
        log(f"  14(c) f64 witness (limit {TRAIN_F64}), card against CPU; "
            "then the largest f32 gradient error against f64 over the "
            "leaf's sensitivity, card and CPU: " + ", ".join(
                f"{k} {w:.2e}; {a:.2f} {b:.2f}"
                for k, (w, a, b) in f64_read.items()))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return {"share": out, "f64": f64_read}


def lm_train_resume(dev) -> dict:
    """14(d): ``launch.train.main`` on the card at SMOKE (6 steps, a
    checkpoint every 3, under ``out/``): a run cut after step 3's
    checkpoint (the later one removed, the pointer back at 3) and
    relaunched ends with the uninterrupted run's loss and state, bit for
    bit; then, in one process, a checkpoint restored into the live
    tensors of a captured step continues it bit for bit."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import init_opt_state, make_train_step
    root = Path("out/train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    args = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "16", "--ckpt-every", "3", "--log-every", "3"]
    full = launch_train.main(args + ["--ckpt-dir", str(root / "a")])
    launch_train.main(args + ["--ckpt-dir", str(root / "b")])
    shutil.rmtree(root / "b" / "step_6")
    (root / "b" / "latest").write_text("3")
    resumed = launch_train.main(args + ["--ckpt-dir", str(root / "b")])
    a, _ = ck.restore(str(root / "a"), device="cpu")
    b, _ = ck.restore(str(root / "b"), device="cpu")
    fa, fb = ck._flatten(a), ck._flatten(b)
    same = resumed == full and all(torch.equal(fa[k], fb[k]) for k in fa)
    log(f"  14(d) launch.train cut at step 3 and relaunched: loss "
        f"{resumed!r} against {full!r} uninterrupted; state "
        f"{'bit for bit' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("14(d): the resumed run differs")

    cfg = get_config(TRAIN_ARCH, smoke=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(TRAIN_SEED))
    opt = init_opt_state(params)
    pipe = TokenPipeline(cfg, 2, 16, seed=TRAIN_SEED, device=dev)
    step_fn = make_train_step(model)
    live = {"params": dict(params.named_parameters()), "opt": opt}
    losses = []
    for i in range(6):
        losses.append(step_fn(params, opt, pipe.next())[2]["loss"])
        if i == 2:
            ck.save(str(root / "live"), 3, live,
                    extra={"pipeline": pipe.state()})
    end = [t.clone() for t in _train_state(params, opt)]
    _, manifest = ck.restore(str(root / "live"), into=live)
    pipe.restore(manifest["extra"]["pipeline"])
    again = [step_fn(params, opt, pipe.next())[2]["loss"] for _ in range(3)]
    cont = (step_fn.captures == 1
            and all(torch.equal(x, y) for x, y in zip(again, losses[3:]))
            and all(torch.equal(x, y)
                    for x, y in zip(_train_state(params, opt), end)))
    log(f"  14(d) a checkpoint restored into a live captured step: steps "
        f"4-6 replayed again {'bit for bit' if cont else 'DIFFER'} (losses "
        + " ".join(f"{float(x):.6f}" for x in again) + ")")
    if not cont:
        raise AssertionError("14(d): the restored captured step differs")
    return {"loss": full, "resumed": resumed, "continued": cont}


def run_train(dev, main_launches: dict) -> dict:
    """Phase 14: LM training.  No kernel of the TiLT path lies on it: its
    launch-count window must read 0 for every kernel."""
    import gc
    import torch
    t0 = time.perf_counter()
    res = {}

    parts = {}

    def part(name, fn):
        t1 = time.perf_counter()
        res[name] = fn(dev)
        parts[name] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.empty_cache()

    def go():
        part("full", lm_train_full)
        part("captured_eager", lm_train_captured_eager)
        part("resume", lm_train_resume)

    drive(main_launches, go)
    if any(main_launches.values()):
        raise AssertionError(f"a TiLT kernel launched on the training "
                             f"path: {main_launches}")
    part("smoke", lm_train_card_cpu)
    res["seconds"] = time.perf_counter() - t0
    res["part_seconds"] = parts
    log(f"LM training phase: {res['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return res

# ---------------------------------------------------------------------------
# phase 15: sharding and the dry-run (repro_torch.launch.sharding, dryrun,
# roofline; launch.train on a mesh)
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                ("qwen3-1.7b", "decode_32k"),
                ("granite-moe-1b-a400m", "train_4k"),
                ("dbrx-132b", "train_4k"))
DRYRUN_DIR = Path("out/dryrun_chip")
DRYRUN_TIMEOUT = 600
HBM_BYTES = 80e9


def _dryrun(arch: str, shape: str, mesh: str, out: Path, *extra):
    """``python -m repro_torch.launch.dryrun`` for one cell, started (its
    own process: a fake process group of 256 ranks, or a real 1-rank
    one, cannot share this one's), its output to ``out`` with ``.log``."""
    with open(out.with_suffix(".log"), "w") as log_file:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--json", str(out),
             *extra],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            stdout=log_file, stderr=subprocess.STDOUT)


def _dryrun_result(label: str, proc, out: Path) -> dict:
    """The cell's record once its process ends; it must be ``ok``."""
    try:
        proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"15: dry-run {label} timed out")
    rec = json.loads(out.read_text()) if out.exists() else {}
    if proc.returncode != 0 or not rec.get("ok"):
        tail = out.with_suffix(".log").read_text()[-2000:]
        raise AssertionError(f"15: dry-run {label} failed (exit "
                             f"{proc.returncode}): {rec.get('error')}\n"
                             f"{tail}")
    if rec.get("device_type") != "cuda":
        raise AssertionError(f"15: dry-run {label} traced "
                             f"{rec.get('device_type')!r} tensors, not cuda")
    return rec


def _state_bytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def dryrun_against_card(dev, rec: dict, full: dict) -> dict:
    """15(b): the ``--mesh local`` dry-run of 14(a)'s cell (qwen3-1.7b,
    remat, batch 8 x 1024, one microbatch) against the card: its argument
    bytes equal the real parameters, AdamW state and batch exactly, and
    its FLOPs ``FlopCounterMode``'s count over one real eager step; its
    predicted peak beside 14(a)'s ``max_memory_allocated``, its compute
    and memory terms beside 14(a)'s ms a step and bound."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import init_opt_state, make_train_step
    model = _lm_model(TRAIN_ARCH, {}, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(TRAIN_SEED))
    opt = init_opt_state(params)
    batch = TokenPipeline(model.cfg, TRAIN_BATCH, TRAIN_SEQ, seed=TRAIN_SEED,
                          device=dev).next()
    real_bytes = _state_bytes((list(params.parameters()), opt, batch))
    with FlopCounterMode(display=False) as fc:
        make_train_step(model).eager(params, opt, batch)
    torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    del params, opt
    args = rec["memory"]["argument_size_in_bytes"]
    r = rec["roofline"]
    row = {"argument_bytes": args, "real_bytes": real_bytes,
           "flops": rec["cost"]["flops"], "real_flops": real_flops,
           "peak_bytes": rec["per_device_bytes"],
           "real_max_allocated": full["max_allocated_bytes"],
           "compute_ms": r["compute_s"] * 1e3,
           "memory_ms": r["memory_s"] * 1e3, "step_ms": full["p50_ms"],
           "bound_ms": full["bound_ms"], "trace_s": rec["lower_s"]}
    log(f"  15(b) dry-run at 14(a)'s cell on the card's (1, 1) mesh: "
        f"argument bytes {args} against the real state's {real_bytes}; "
        f"FLOPs {row['flops']:.6e} against FlopCounterMode's "
        f"{real_flops:.6e} over a real eager step; predicted peak "
        f"{row['peak_bytes'] / 2**30:.2f} GiB against 14(a)'s max "
        f"allocated {row['real_max_allocated'] / 2**30:.2f} GiB; terms: "
        f"compute {row['compute_ms']:.1f} ms, memory "
        f"{row['memory_ms']:.1f} ms (dominant {r['dominant']}) against "
        f"14(a)'s {row['step_ms']:.1f} ms a step and its "
        f"{row['bound_ms']:.1f} ms causal bound; traced in "
        f"{rec['lower_s']} s")
    if args != real_bytes:
        raise AssertionError(f"15(b): argument bytes {args} != {real_bytes}")
    if row["flops"] != real_flops:
        raise AssertionError(f"15(b): FLOPs {row['flops']} != {real_flops}")
    return row


def mesh_trainer(dev, resume: dict) -> dict:
    """15(c): 14(d)'s ``launch.train.main`` runs at SMOKE (on a 1-rank
    NCCL mesh, ``DTensor`` parameters and AdamW state), the uninterrupted
    one and the one cut after step 3's checkpoint and relaunched, against
    a plain ``make_train_step`` loop over plain tensors with
    ``launch.train``'s seeds and settings: the same loss and state, bit
    for bit.  Then a mesh train step alone: its graphs and the syncs of a
    steady step."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, shardctx
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import init_opt_state, make_train_step
    from repro_torch.train.optimizer import AdamWConfig
    steps = 6
    cfg = get_config(TRAIN_ARCH, smoke=True)
    model = build_model(cfg, device=dev)
    # launch.train's: seed 0, the pipeline's default seed, lr 3e-3,
    # warmup max(steps // 20, 1), one microbatch
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = init_opt_state(params)
    pipe = TokenPipeline(cfg, 2, 16, device=dev)
    step_fn = make_train_step(model, AdamWConfig(
        lr=3e-3, total_steps=steps, warmup_steps=max(steps // 20, 1)))
    for _ in range(steps):
        _, _, metrics = step_fn(params, opt, pipe.next())
    loss = float(metrics["loss"])
    root = Path("out/train_ckpt")
    shutil.rmtree(root / "plain", ignore_errors=True)
    ck.save(str(root / "plain"), steps,
            {"params": dict(params.named_parameters()), "opt": opt})
    del params, opt
    flat = ck._flatten(ck.restore(str(root / "plain"), device="cpu")[0])
    same = {}
    for d in ("a", "b"):
        got, _ = ck.restore(str(root / d), device="cpu")
        got = ck._flatten(got)
        same[d] = got.keys() == flat.keys() and all(
            torch.equal(got[k], flat[k]) for k in flat)
    ok = resume["loss"] == resume["resumed"] == loss and all(same.values())
    log(f"  15(c) 14(d)'s launch.train on a 1-rank NCCL mesh against a "
        f"plain make_train_step loop: loss {resume['loss']!r} "
        f"uninterrupted, {resume['resumed']!r} relaunched, {loss!r} plain; "
        f"state: " + ", ".join(
            f"{'uninterrupted' if d == 'a' else 'relaunched'} "
            f"{'bit for bit' if v else 'DIFFERS'}" for d, v in same.items()))
    if not ok:
        raise AssertionError("15(c): the mesh trainer differs from the "
                             "plain loop")

    params = model.init(torch.Generator(device=dev).manual_seed(TRAIN_SEED))
    opt = init_opt_state(params)
    mesh = make_local_mesh()
    shardctx.set_mesh_axes(mesh.mesh_dim_names, mesh)
    try:
        psh = SH.place_params(params, mesh, cfg)
        SH.place_opt_state(opt, SH.opt_shardings(psh, mesh))
        pipe = TokenPipeline(cfg, 2, 16, seed=TRAIN_SEED, device=dev)
        step_fn = make_train_step(model)
        for _ in range(3):
            step_fn(params, opt, SH.place_batch(pipe.next(), mesh))
        b = SH.place_batch(pipe.next(), mesh)
        syncs = count_syncs(lambda: step_fn(params, opt, b))
    finally:
        shardctx.clear()
    log(f"  15(c) a mesh train step (DTensor parameters, 1-rank NCCL "
        f"mesh): {step_fn.captures} graph(s) captured over 4 steps, "
        f"{syncs} syncs a steady step")
    return {"loss": loss, "state": same, "captures": step_fn.captures,
            "syncs": syncs}


def start_dryrun_cells() -> dict:
    """15(a)'s five cells, each started as its own process.  They run on
    the host's CPU (fake tensors: nothing is allocated on the card) and
    are started before phase 14, whose steps are captured graphs the card
    replays, so that their tracing overlaps it; phase 15 reads them."""
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    for f in DRYRUN_DIR.glob("*.json"):
        f.unlink()
    log(f"15(a): {len(DRYRUN_CELLS)} dry-run cells started beside phase 14")
    return {(a, s): (_dryrun(a, s, "single", DRYRUN_DIR / f"{a}_{s}.json"),
                     DRYRUN_DIR / f"{a}_{s}.json") for a, s in DRYRUN_CELLS}


def run_dryrun(dev, main_launches: dict, train: dict, procs: dict) -> dict:
    """Phase 15: 15(b)'s local cell starts as a subprocess; meanwhile
    15(b)'s real step and 15(c) run here; then the five cells of 15(a)
    (started before phase 14) are read.  No kernel of the TiLT path lies
    on it: the launch-count window reads 0 for every kernel."""
    import gc
    import torch
    t0 = time.perf_counter()
    local_out = DRYRUN_DIR / "local.json"
    local = _dryrun(TRAIN_ARCH, "train_4k", "local", local_out, "--batch",
                    str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--micro", "1")
    res = {}

    def go():
        res["trainer"] = mesh_trainer(dev, train["resume"])
        gc.collect()
        torch.cuda.empty_cache()
        res["card"] = dryrun_against_card(
            dev, _dryrun_result("local", local, local_out), train["full"])

    try:
        drive(main_launches, go)
    finally:
        if local.poll() is None:
            local.kill()
            local.wait()
    if any(main_launches.values()):
        raise AssertionError(f"a TiLT kernel launched on the sharding "
                             f"path: {main_launches}")
    cells = {}
    for (a, s), (proc, out) in procs.items():
        rec = _dryrun_result(f"{a} {s}", proc, out)
        r = rec["roofline"]
        cells[f"{a}/{s}"] = rec
        gb = rec["per_device_bytes"] / 1e9
        log(f"  15(a) {a} {s} on the (16, 16) mesh: {gb:.2f} GB a device "
            f"({'fits' if gb * 1e9 <= HBM_BYTES else 'exceeds'} 80 GB), "
            f"dominant {r['dominant']} (compute {r['compute_s']:.3f} s, "
            f"memory {r['memory_s']:.3f} s, collective "
            f"{r['collective_s']:.3f} s), roofline fraction "
            f"{r['roofline_fraction']:.4f}, traced in {rec['lower_s']} s")
    res["cells"] = cells
    res["seconds"] = time.perf_counter() - t0
    log(f"sharding and dry-run phase: {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 16: the examples (examples_torch/)
# ---------------------------------------------------------------------------

EXAMPLE_TRAIN_STEPS = 100       # train_lm's own default, at --full-100m
_TRAIN_LOSS = re.compile(r"\[train\] step (\d+) loss (\S+)")


def _example_summary(name: str, r: dict) -> dict:
    """The figures an example printed, without its tensors."""
    if name == "quickstart":
        return {k: r[k] for k in ("uptrend_ticks", "intervals")}
    if name == "stream_analytics":
        return {app: {"events_per_s": a["events_per_s"],
                      "output_events": a["output_events"], "mode": a["mode"]}
                for app, a in r.items()}
    if name == "multikey_analytics":
        f, d = r["fraud"], r["dashboard"]
        return {"events_per_s": f["events_per_s"], "flagged": f["flagged"],
                "caught": f["caught"], "injected": f["injected"],
                "query_events_per_s": d["query_events_per_s"],
                "sharing_ratio": d["sharing_ratio"]}
    if name == "late_data":
        return {k: v for k, v in r.items() if k not in ("value", "valid")}
    if name == "metrics_observability":
        c = r["snapshot"]["counters"]
        h = r["snapshot"]["histograms"]["runner.step_seconds"]
        return {"chunks": c["runner.chunks"]["value"],
                "dirty_units": c["runner.dirty_units"]["value"],
                "bucket_picks": r["bucket_picks"],
                "captures": sum(r["captures"].values()),
                "step_p50_s": h["p50"], "step_p99_s": h["p99"]}
    if name == "plan_audit":
        return {"verdict": r["verdict"], "bad_verdict": r["bad_verdict"],
                "bad_codes": [f.code for f in r["bad_findings"]]}
    if name == "serving_loop":
        return {k: r[k] for k in ("plan_source", "flagged", "first_s",
                                  "p50_s", "p99_s", "admitted",
                                  "sealed_chunks", "shed",
                                  "admit_to_result_p50_s")} | {
            "captures": sum(r["captures"].values())}
    if name == "serve_lm":
        return {"sequences": r["sequences"], "tokens": r["tokens"]}
    return {k: r[k] for k in ("arch", "n_params", "final_loss", "losses")}


def _train_example(mod, ckpt: str) -> dict:
    """``train_lm --full-100m`` with its checkpoints in ``ckpt``; the
    losses it logged, read back from what it printed (and printed
    again)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = mod.main(["--full-100m", "--steps", str(EXAMPLE_TRAIN_STEPS),
                      "--ckpt-dir", ckpt])
    sys.stdout.write(buf.getvalue())
    r["losses"] = [float(v) for _, v in _TRAIN_LOSS.findall(buf.getvalue())]
    return r


def run_examples(dev, main_launches: dict) -> dict:
    """Phase 16: (a) every example of ``examples_torch/`` at its shipped
    size on the card, through its ``main`` with no ``--device``, in one
    launch-count window, each with its own checks; (b) each TiLT example
    on the card against the CPU at the CPU tests' sizes
    (``tests/torch_examples_common.py``: exact figures, outputs within
    ``tolerance``); (c) ``python examples_torch/quickstart.py`` from a
    shell.  All from a temporary working directory, removed after."""
    import contextlib
    import io
    import math
    import shutil
    import tempfile
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_examples_common as C
    from repro_torch import obs

    t_phase = time.perf_counter()
    card = card_line()
    res = {"card": card, "seconds": {}, "figures": {}}
    tmp = tempfile.mkdtemp(prefix="examples_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        # (a) the shipped sizes, on the card
        runs = [(n, n) for n in C.TILT if n != "serving_loop"]
        runs += [("serving_loop", "serving_loop"),
                 ("serving_loop", "serving_loop (again)"),
                 ("serve_lm", "serve_lm"), ("train_lm", "train_lm")]
        shipped = {}
        for name, label in runs:
            mod = C.load(name)
            if name == "train_lm":
                ckpt = os.path.join(tmp, "ckpt")
                r, dt = drive(main_launches,
                              lambda: _train_example(mod, ckpt))
                shutil.rmtree(ckpt)
            else:
                r, dt = drive(main_launches, lambda: mod.main([]))
            shipped[label] = r
            res["seconds"][label] = dt
            res["figures"][label] = _example_summary(name, r)
            log(f"16(a) {label}: {dt:.2f} s on {card}: "
                f"{json.dumps(res['figures'][label], default=str)}")
        # each example's own checks (late_data's bit-identity and
        # metrics_observability's schema are asserted inside the example;
        # serving_loop's steady tail ran under set_sync_debug_mode("error"))
        pa = shipped["plan_audit"]
        if (pa["verdict"], pa["bad_verdict"]) != ("clean", "error"):
            raise AssertionError(f"plan_audit: {pa['verdict']}, "
                                 f"{pa['bad_verdict']}")
        mo = shipped["metrics_observability"]
        if obs.validate_snapshot(mo["snapshot"]) or mo["compiles"][
                "retraces"]:
            raise AssertionError(f"metrics_observability: retraces "
                                 f"{mo['compiles']['retraces']}")
        plans = [shipped[k]["plan_source"]
                 for k in ("serving_loop", "serving_loop (again)")]
        if plans != ["cold", "warm"]:
            raise AssertionError(f"serving_loop plans {plans}")
        if (shipped["serve_lm"]["sequences"],
                shipped["serve_lm"]["tokens"]) != (8, 128):
            raise AssertionError(f"serve_lm: {shipped['serve_lm']}")
        losses = shipped["train_lm"]["losses"]
        if not (losses and all(map(math.isfinite, losses))
                and losses[-1] < losses[0]):
            raise AssertionError(f"train_lm losses {losses}")
        mk = C.load("multikey_analytics")
        res["session_vs_solo"] = C.hold_vol_heads_solo(
            shipped["multikey_analytics"],
            {"N_TICKS": mk.N_TICKS, "N_PARTS": mk.N_PARTS}, 64, dev)
        # no example sums a window under 8 ticks or asks for
        # sum_algo="soe", so none reaches prefix_scan
        for k in ("sliding_assoc", "seg_dirty"):
            if not main_launches.get(k, 0):
                raise AssertionError(f"{k} was never launched by the "
                                     "examples")
        del shipped
        import gc
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the card against the CPU at the tests' sizes
        held = {}
        for name in C.TILT:
            mod = C.load(name)
            consts, argv = C.SIZES[name]
            pairs = []
            with contextlib.redirect_stdout(io.StringIO()):
                for where, extra in (("cuda", []), ("cpu", ["--device",
                                                            "cpu"])):
                    more = ({"CACHE": os.path.join(tmp, f"cache_{where}")}
                            if name == "serving_loop" else {})
                    with C.sized(mod, {**consts, **more}):
                        n = 2 if name == "serving_loop" else 1
                        pairs.append([mod.main(argv + extra)
                                      for _ in range(n)])
            held[name] = [C.hold(name, C.figures(name, card_r),
                                 C.figures(name, cpu_r))
                          for card_r, cpu_r in zip(*pairs)]
            if name == "multikey_analytics":
                C.hold_vol_heads_solo(pairs[0][0], consts,
                                      int(argv[0]), dev)
            diffs = [v["max_abs_diff"] for h in held[name] for v in h.values()]
            log(f"16(b) {name}: card = CPU at the tests' sizes (exact "
                f"figures; {len(diffs)} outputs, largest difference "
                f"{max(diffs, default=0.0):.3g})")
        res["card_vs_cpu"] = held

        # (c) from a shell
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples_torch" / "quickstart.py")],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        name = torch.cuda.get_device_name(0)
        if proc.returncode or f"(device {name})" not in proc.stdout:
            raise AssertionError(f"quickstart from a shell: rc "
                                 f"{proc.returncode}\n{proc.stdout}\n"
                                 f"{proc.stderr[-2000:]}")
        res["seconds"]["quickstart (shell)"] = time.perf_counter() - t0
        log(f"16(c) python examples_torch/quickstart.py: exit 0 on {name} "
            f"in {res['seconds']['quickstart (shell)']:.1f} s")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"] = dict(main_launches)
    res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"examples phase: {res['phase_seconds']:.1f} s; launches "
        f"{main_launches}")
    return res


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

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"card at start: {card_state()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    def build():
        t0 = time.perf_counter()
        library.load()
        log(f"kernels built in {library.build_seconds:.2f} s (load "
            f"{time.perf_counter() - t0:.2f} s): {library.path.name}")
        for line in library.build_log.splitlines():
            if "registers" in line:
                log("  " + line.strip())

    phase("1 build", build)

    def kernels():
        errs, rows = check_kernels(dev)
        check_change_kernels(dev, errs, rows)
        return errs, rows

    errs, rows = phase("2 kernels", kernels)

    single, keyed_launches, runner_launches, one_shot_launches = {}, {}, {}, {}
    apps = phase("3 apps", run_apps, dev, single, N_TICKS, PART, N_CMP_PARTS)
    for k in wr.launches:
        if single.get(k, 0) == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    keyed = phase("4 keyed", run_keyed, dev, keyed_launches, KEYS,
                  KEY_TICKS, CMP_KEYS)
    runners = phase("5-6 runner", run_runners, dev, runner_launches)
    one_shot = phase("7 sparse_run", run_one_shot, dev, one_shot_launches)
    phase("2 runner shapes", time_runner_shapes, dev, errs, rows, runners)
    session_launches, ingest_launches = {}, {}
    sessions = phase("8 sessions", run_sessions, dev, session_launches)
    ingest = phase("9 ingest", run_ingest, dev, ingest_launches)
    serve_launches, mesh_launches = {}, {}
    serving = phase("10 serving", run_serving, dev, serve_launches, errs)
    mesh = phase("11 mesh", run_mesh, dev, mesh_launches, errs)
    audit = phase("12 audit", run_audit, dev, errs)
    import torch.distributed as dist
    dist.destroy_process_group()
    lm_launches, train_launches = {}, {}
    lm = phase("13 LM serving", run_lm, dev, lm_launches)
    dryrun_procs = start_dryrun_cells()
    dryrun_launches = {}
    try:
        train = phase("14 LM training", run_train, dev, train_launches)
        dryrun = phase("15 sharding and dry-run", run_dryrun, dev,
                       dryrun_launches, train, dryrun_procs)
    finally:
        for proc, _ in dryrun_procs.values():   # every process it started
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    example_launches = {}
    examples = phase("16 examples", run_examples, dev, example_launches)
    windows = {"partition_run": single, "batch_run": keyed_launches,
               "runner": runner_launches, "sparse_run": one_shot_launches,
               "session": session_launches, "ingest": ingest_launches,
               "serve": serve_launches, "mesh": mesh_launches,
               "lm": lm_launches, "train": train_launches,
               "dryrun": dryrun_launches, "examples": example_launches}
    launches = {k: sum(w.get(k, 0) for w in windows.values())
                for k in KERNELS}
    for k in ("seg_dirty",):
        if not (runner_launches.get(k, 0) and one_shot_launches.get(k, 0)):
            raise AssertionError(f"{k} was never launched on the sparse "
                                 "runner or sparse_run path")
    for w in ("session", "ingest", "serve"):
        for k in ("sliding_assoc", "seg_dirty"):
            if not windows[w].get(k, 0):
                raise AssertionError(f"{k} was never launched in the {w} "
                                     "phase")
    for k in OFF_PATH:
        if launches[k]:
            raise AssertionError(f"{k} has no caller, yet launched")
    log("main-path launches: " + ", ".join(
        f"{w} {c}" for w, c in windows.items()) + f"; total {launches}")

    Path("out").mkdir(exist_ok=True)
    detail = {"card": card, "apps": apps, "keyed": keyed,
              "runner": runners, "sparse_run": one_shot,
              "session": sessions, "ingest": ingest, "serve": serving,
              "mesh": mesh, "audit": audit, "lm": lm, "train": train,
              "dryrun": dryrun, "examples": examples,
              "phase_seconds": PHASE_SECONDS,
              "kernels": {f"{k}/{lab}": v for (k, lab), v in rows.items()},
              "launches": dict(windows, total=launches)}
    Path("out/chip_smoke.json").write_text(json.dumps(detail, indent=1,
                                                      default=str))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[(name, "single")]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in PHASE_SECONDS.items()))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all; card "
        f"at the end: {card_state()}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--first-result":
        sys.exit(first_result_main(sys.argv[2]))
    sys.exit(main())
