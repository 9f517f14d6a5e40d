"""One run of one cell: set-up, the measured window, the traced stretch,
the readers, and the comparison with the plain reference.

Everything that belongs to a configuration, a traffic mix or a metric is
data or a file of its own, found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json``: the deployment (the app of the port's app
  registry and its arguments, keys, segment length and segments a chunk,
  execution policy), the reference module and its parameters, and the
  limit of each number the comparison reports;
* ``traffic/<traffic>.json``: the mix, read by :mod:`tiltbench.gen`, and
  the loop that offers it (``closed``, or ``open`` at a fixed rate);
* ``metrics/<metric>.py``: a reader ``read(ctx) -> float | None`` of one
  metric from the run's context (:class:`Ctx`); ``None`` leaves the metric
  out of the line;
* ``reference/<module>.py``: ``evaluate``, ``numbers`` and ``tail_ticks``
  of the plain reference.

A chunk's geometry (its ticks, its output ticks) is read from the built
runner, and its bytes from the grids; nothing of it is typed into a
configuration.

The program under test is ``repro_torch``: its app registry, planner and
compiler build the query, its chunked ``Runner`` steps it, and its
ahead-of-time capture prepares every step before the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from . import gen, roofline
from . import trace as trace_mod

__all__ = ["BENCH", "ROOT", "FORBIDDEN", "COMPARE_CHUNKS", "TRACE_SECONDS",
           "Ctx", "Cell", "load_cell", "forbidden_modules", "percentile",
           "run_cell"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
COMPARE_CHUNKS = 12     # chunks of the window held against the reference
TRACE_SECONDS = 2.0     # the traced stretch of a --trace 1 run


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that a run may not hold, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(xs: List[float], q: float) -> float:
    """The ``q``-th percentile of all of ``xs``, interpolated linearly
    between the two nearest ranks."""
    if not xs:
        raise ValueError("no samples")
    s = sorted(xs)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


# -- the cell, from BENCHMARK.json and the files it names ------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: List[dict]        # the entries this run reports, in order
    compare_chunks: int = COMPARE_CHUNKS
    trace_seconds: float = TRACE_SECONDS


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, trace: bool, overrides: Optional[dict] = None,
              bench: Optional[dict] = None,
              traffic_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``, with its
    mixes in ``traffic_dir``): its configuration, traffic and the metrics
    a run reports (end-to-end without ``trace``, per-layer with it).
    ``overrides`` (``{"config": {...}, "traffic": {...}, "compare_chunks":
    n, "trace_seconds": s}``) replaces keys of either file and the run's
    constants: the tests' small sizes."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    traffic_dir = traffic_dir if traffic_dir is not None else BENCH / "traffic"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(ROOT / conf["file"])
    traffic = _json(Path(traffic_dir) / f"{w['traffic']}.json")
    over = overrides or {}
    config.update(over.get("config", {}))
    traffic.update(over.get("traffic", {}))
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, metrics=metrics,
                compare_chunks=int(over.get("compare_chunks",
                                            COMPARE_CHUNKS)),
                trace_seconds=float(over.get("trace_seconds",
                                             TRACE_SECONDS)))


def _reader(name: str) -> Callable:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "tiltbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the kernels' shapes, recorded at their wrappers while steps are built --

class ShapeLog:
    """The bytes of every ``sliding_assoc`` and ``seg_dirty`` call the
    wrappers see while :meth:`recording`, tagged with the number of work
    units the query body was evaluating (a capacity bucket of the sparse
    body, or every unit of the dense one).  Calls outside the body (the
    sparse body's change detection) are kept apart, once per shape."""

    def __init__(self):
        self.per_units: Dict[int, List[tuple]] = {}
        self.outside: Dict[tuple, int] = {}
        self._cur: Optional[list] = None

    def tag(self, outs_fn):
        def outs(inputs):
            units = int(next(iter(inputs.values()))[1].shape[0])
            prev, self._cur = self._cur, []
            try:
                return outs_fn(inputs)
            finally:
                self.per_units.setdefault(units, self._cur)
                self._cur = prev
        return outs

    def _note(self, kernel: str, key: tuple, nbytes: int) -> None:
        if self._cur is not None:
            self._cur.append((kernel, key, nbytes))
        else:
            self.outside[(kernel, key)] = nbytes

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.kernels import sparse_compact as sc
        from repro_torch.kernels import window_reduce as wr
        orig_s, orig_d = wr.sliding_assoc, sc.seg_dirty

        def sliding(x, window, op):
            R, T = x.shape
            self._note("sliding_assoc", (R, T, int(window), op),
                       roofline.sliding_assoc_bytes(R, T, x.element_size()))
            return orig_s(x, window, op)

        def seg_dirty(mats, geoms, n_segs):
            lead = tuple(mats[0].shape[:-2])
            units = 1
            for d in lead:
                units *= int(d)
            mm = [(tuple(m.shape), m.element_size()) for m in mats]
            self._note("seg_dirty", (tuple(mm), int(n_segs)),
                       roofline.seg_dirty_bytes(mm, units, n_segs))
            return orig_d(mats, geoms, n_segs)

        wr.sliding_assoc, sc.seg_dirty = sliding, seg_dirty
        try:
            yield self
        finally:
            wr.sliding_assoc, sc.seg_dirty = orig_s, orig_d

    def chunk_bytes(self, kernel: str, units: int) -> int:
        """Bytes ``kernel`` moves in one chunk whose body evaluated
        ``units`` units (0 where it was not seen)."""
        inside = sum(b for k, _, b in self.per_units.get(units, [])
                     if k == kernel)
        return inside + sum(b for (k, _), b in self.outside.items()
                            if k == kernel)

    def seen(self, kernel: str) -> bool:
        return (any(k == kernel for calls in self.per_units.values()
                    for k, _, _ in calls)
                or any(k == kernel for k, _ in self.outside))


# -- the context the readers read --------------------------------------------

@dataclasses.dataclass
class Ctx:
    """What one run measured, for the readers in ``metrics/``."""
    loop: str
    setup_s: float
    chunks: int                    # chunks stepped in the window
    window_s: float                # first dispatch to the closing sync
    keyticks_per_chunk: int
    latencies_s: List[float]       # open loop: due to result, per chunk
    step_host_s: float             # host time inside Runner.step, in all
    chunk_bytes: int               # what one chunk's semantics need
    sparse: bool
    units: int                     # work units a chunk presents
    dirty: Optional[dict] = None   # Runner.dirty_stats() over the window
    picks: Optional[Dict[int, int]] = None   # capacity -> chunks, window
    trace: Optional[dict] = None   # trace.read() of the traced stretch
    trace_chunks: int = 0
    trace_picks: Optional[Dict[int, int]] = None
    shapes: Optional[ShapeLog] = None

    def stretch_bytes(self, kernel: str) -> Optional[float]:
        """Bytes ``kernel`` moved over the traced stretch, from its shapes
        at each capacity and the chunks that picked it."""
        if self.shapes is None or not self.shapes.seen(kernel):
            return None
        if self.sparse:
            if not self.trace_picks:
                return None
            per_cap = {c: self.shapes.chunk_bytes(kernel, c)
                       for c in self.trace_picks}
            return roofline.over_picks(per_cap, self.trace_picks)
        return float(self.trace_chunks
                     * self.shapes.chunk_bytes(kernel, self.units))


# -- set-up ------------------------------------------------------------------

def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _grids(ring, chunk_ticks: int):
    from repro_torch.core.stream import SnapshotGrid
    return [{n: SnapshotGrid(value=c["value"], valid=c["valid"],
                             t0=i * chunk_ticks, prec=1)
             for n, c in chunk.items()} for i, chunk in enumerate(ring)]


def _build(config: dict, shapes: ShapeLog):
    from repro_torch.core.compile import compile_query
    from repro_torch.data.apps import make_keyed_app
    from repro_torch.engine import Runner
    from repro_torch.engine.policy import ExecPolicy
    from repro_torch.engine.runner import body_spec_of
    app = make_keyed_app(config["app"], **config.get("app_args", {}))
    policy = ExecPolicy(**config["policy"])
    exe = compile_query(app.query.node, int(config["out_len"]),
                        sparse=policy.sparse)
    spec = body_spec_of(exe)
    spec = dataclasses.replace(spec, outs_fn=shapes.tag(spec.outs_fn))
    return Runner(spec, policy, n_keys=int(config["n_keys"]),
                  segs_per_chunk=int(config["segs_per_chunk"]))


def _chunk_ticks(runner) -> int:
    """Ticks of one key in a chunk, as the runner lays chunks out: a
    segment's core times the segments a chunk (every input alike)."""
    ticks = {s.core * runner.n_segs
             for s in runner.spec.input_specs.values()}
    if len(ticks) != 1:
        raise ValueError(f"inputs of unequal chunk lengths {sorted(ticks)}")
    return ticks.pop()


def _tick_bytes(value, valid) -> int:
    """Bytes of one key-tick of a grid: each leaf of its value and its
    valid flag."""
    leaves = list(value.values()) if isinstance(value, dict) else [value]
    return sum(x.element_size() for x in leaves) + valid.element_size()


def _alloc_counts(on_card: bool) -> tuple:
    """(cudaMalloc, cudaFree) calls of the caching allocator so far."""
    if not on_card:
        return (0, 0)
    import torch
    st = torch.cuda.memory_stats()
    return (st.get("num_device_alloc", 0), st.get("num_device_free", 0))


@contextlib.contextmanager
def _gc_pauses(out: List[float]):
    """Record the length of every garbage collection inside the body."""
    t = [0.0]

    def cb(phase, info):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            out.append(time.perf_counter() - t[0])
    gc.callbacks.append(cb)
    try:
        yield
    finally:
        gc.callbacks.remove(cb)


def _picks(runner) -> Optional[Dict[int, int]]:
    vec = runner.metrics.snapshot()["vectors"].get("runner.bucket_picks")
    if vec is None:
        return None
    return {int(c): int(n) for c, n in zip(vec["labels"], vec["values"])}


# -- the loops ---------------------------------------------------------------

class Keep:
    """A sample of the window's chunks, drawn from the seed (reservoir
    sampling, so every chunk is as likely), and always the last one."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = int(k), random.Random(seed)
        self.kept: List[tuple] = []
        self.last: Optional[tuple] = None
        self.seen = 0

    def offer(self, c: int, out) -> None:
        if len(self.kept) < self.k:
            self.kept.append((c, out))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = (c, out)
        self.seen += 1
        self.last = (c, out)

    def chunks(self) -> List[tuple]:
        out = dict(self.kept)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return sorted(out.items(), key=lambda kv: kv[0])


@dataclasses.dataclass
class Loop:
    chunks: int = 0
    window_s: float = 0.0
    step_host_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    late_s: List[float] = dataclasses.field(default_factory=list)


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def closed_loop(runner, grids, c0: int, seconds: float, sync,
                keep: Optional[Keep] = None, spans: bool = False) -> Loop:
    """Step chunks back to back for ``seconds``, dispatched ahead with no
    wait a chunk; the window ends with one synchronize."""
    R, res = len(grids), Loop()
    pc = time.perf_counter
    t0 = pc()
    c = c0
    while pc() - t0 < seconds:
        with _span("tiltbench.step", spans):
            a = pc()
            out = runner.step(grids[c % R])
            res.step_host_s += pc() - a
        if keep is not None:
            keep.offer(c, out)
        c += 1
    with _span("tiltbench.sync", spans):
        sync()
    res.window_s = pc() - t0
    res.chunks = c - c0
    return res


def open_loop(runner, grids, c0: int, seconds: float, rate: float,
              keyticks: int, event, keep: Optional[Keep] = None,
              spans: bool = False) -> Loop:
    """Chunks fall due on a fixed schedule, one every ``keyticks / rate``
    seconds (a chunk is due when its last tick is); each is stepped when
    due, or at once when the runner is behind, and waited for as a
    blocked served call waits, on a CUDA event.  A chunk's latency runs
    from when it was due to when its result is complete; the window holds
    the chunks due within ``seconds``."""
    R, res = len(grids), Loop()
    period = keyticks / rate
    pc = time.perf_counter
    t0 = pc()
    i = 0
    while (i + 1) * period <= seconds:
        due = t0 + (i + 1) * period
        with _span("tiltbench.wait", spans):
            now = pc()
            while now < due:
                now = pc()
        res.late_s.append(now - due)
        c = c0 + i
        with _span("tiltbench.step", spans):
            out = runner.step(grids[c % R])
            event.record()
            res.step_host_s += pc() - now
        with _span("tiltbench.sync", spans):
            event.synchronize()
        res.latencies_s.append(pc() - due)
        if keep is not None:
            keep.offer(c, out)
        i += 1
    res.window_s = pc() - t0
    res.chunks = i
    return res


class _HostEvent:
    """The CPU stand-in for a CUDA event: steps there are synchronous."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


# -- one run -----------------------------------------------------------------

class Session:
    """The program built for one cell on one device, and the ring of one
    seed loaded into it: :meth:`load` makes the ring, prepares every step
    ahead (the first time) or starts a fresh stream (after that) and
    steps the warm-up chunks; :meth:`window` and :meth:`stretch` run the
    cell's loop; :meth:`compare` holds chunks against the reference."""

    def __init__(self, cell: Cell, device: str = "cuda"):
        import torch
        self.cell, self.cfg, self.tr = cell, cell.config, cell.traffic
        self.dev = torch.device(device)
        self.on_card = self.dev.type == "cuda"
        if self.on_card:
            self.sync = torch.cuda.synchronize
            self.event = torch.cuda.Event()
        else:
            self.sync = lambda: None
            self.event = _HostEvent()
        self.shapes = ShapeLog()
        with self.shapes.recording():
            self.runner = _build(self.cfg, self.shapes)
        self.K, self.T = self.runner.n_keys, _chunk_ticks(self.runner)
        self.kt = gen.chunk_keyticks(self.K, self.T)
        self.report = None
        self.ring = self.grids = None
        self.chunk_bytes = 0
        self.c = 0

    def load(self, seed: int) -> None:
        self.ring = self.grids = None
        self.ring = gen.make_ring(self.tr, self.K, self.T, seed, self.dev)
        self.grids = _grids(self.ring, self.T)
        with self.shapes.recording():
            if self.report is None:
                from repro_torch.serve.aot import aot_capture
                self.report = aot_capture(self.runner, None,
                                          chunks=self.grids[0])
            else:
                self.runner.reset()
            self.c = 0
            # the window keeps up to compare_chunks + 1 outputs alive: hold
            # as many here, so the allocator has their blocks cached
            held: list = []
            for _ in range(int(self.tr["warmup_chunks"])):
                held.append(self.runner.step(
                    self.grids[self.c % len(self.grids)]))
                held = held[-(self.cell.compare_chunks + 2):]
                self.c += 1
            self.sync()
            self.chunk_bytes = self._chunk_bytes(held[-1])
            del held
        self.runner.metrics.reset_after_warmup()

    def _chunk_bytes(self, out) -> int:
        """What one chunk's semantics need (:func:`roofline.chunk_bytes`):
        the runner's chunk and output ticks, the bytes a key-tick of the
        inputs and of the output grid, and the tail the reference says
        the query reads back."""
        ref = importlib.import_module(
            f"tiltbench.reference.{self.cfg['reference']['module']}")
        (name, chunk), = self.ring[0].items()
        return roofline.chunk_bytes(
            self.K, self.T, _tick_bytes(chunk["value"], chunk["valid"]),
            out.valid.shape[-1], _tick_bytes(out.value, out.valid),
            ref.tail_ticks(self.cfg["reference"]["params"]))

    def captures(self) -> int:
        return sum(self.runner.metrics.tracer.captures().values())

    def window(self, seconds: float, keep: Optional[Keep] = None,
               spans: bool = False) -> Loop:
        if self.tr["loop"] == "open":
            loop = open_loop(self.runner, self.grids, self.c, seconds,
                             float(self.tr["rate_keyticks_per_s"]), self.kt,
                             self.event, keep, spans)
        else:
            loop = closed_loop(self.runner, self.grids, self.c, seconds,
                               self.sync, keep, spans)
        self.c += loop.chunks
        return loop

    def compare(self, compared: List[tuple], outputs=None) -> tuple:
        """``(worst, failed)``: the largest of each number over the chunks
        ``[(stream chunk, output grid), ...]`` and how many chunks broke a
        limit.  ``outputs(prev, cur)`` stands in for the program's output
        grid where given (the control)."""
        ref = importlib.import_module(
            f"tiltbench.reference.{self.cfg['reference']['module']}")
        params, limits = self.cfg["reference"]["params"], self.cfg["limits"]
        worst = {n: 0.0 for n in limits}
        failed, R = 0, len(self.ring)
        for ci, out in compared:
            prev, cur = self.ring[(ci - 1) % R], self.ring[ci % R]
            if outputs is not None:
                value, valid = outputs(ref, prev, cur, params)
            else:
                value, valid = out.value, out.valid
            nums = ref.numbers(value, valid, prev, cur, params)
            bad = False
            for n in limits:
                worst[n] = max(worst[n], nums[n])
                bad |= not nums[n] <= limits[n]
            failed += bad
        return worst, failed

    def free_program(self) -> None:
        """Drop the runner (its buffers and graphs); the ring stays."""
        self.runner = None
        gc.collect()
        if self.on_card:
            import torch
            torch.cuda.empty_cache()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             overrides: Optional[dict] = None, bench: Optional[dict] = None,
             traffic_dir: Optional[Path] = None) -> dict:
    """Run one cell and return ``{"result": <the result line's object>,
    "checks": {name: {"value", "limit"}}, "ok": bool}``.  ``t_start`` is
    the host clock when the process started (set-up runs from it);
    ``overrides``, ``bench`` and ``traffic_dir`` as :func:`load_cell`
    takes them."""
    import torch
    cell = load_cell(cell_name, trace, overrides, bench, traffic_dir)
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    kind = "cpu"
    if dev.type == "cuda":
        from repro_torch.kernels.build import library
        kind = torch.cuda.get_device_name(dev)
        _log(f"card: {card_line()}")
        torch.cuda.reset_peak_memory_stats(dev)
        library.load()
        _log(f"kernel library: {library.path} (built in "
             f"{library.build_seconds:.1f} s; 0.0 = cached)")
    ses = Session(cell, device)
    ses.load(seed)
    _log(f"prepared ahead: {ses.report}")
    captures0 = ses.captures()
    gc.collect()
    gc.freeze()
    keep = Keep(cell.compare_chunks, seed)
    setup_s = time.perf_counter() - t_start

    pauses: List[float] = []
    mem0 = _alloc_counts(ses.on_card)
    with _gc_pauses(pauses):
        loop = ses.window(seconds, keep)
    mem1 = _alloc_counts(ses.on_card)
    if tr["loop"] == "open":
        late = sorted(loop.late_s)
        worst = sorted(range(len(loop.late_s)),
                       key=lambda i: -loop.late_s[i])[:3]
        _log(f"generator late: p50 {percentile(late, 50) * 1e3:.4f} ms, "
             f"max {late[-1] * 1e3:.4f} ms over {len(late)} chunks (worst "
             f"at window chunks {worst}); rate "
             f"{float(tr['rate_keyticks_per_s']):.6g} keyticks/s")
    _log(f"in the window: {len(pauses)} garbage collections, longest "
         f"{max(pauses, default=0.0) * 1e3:.3f} ms; device allocations "
         f"{mem1[0] - mem0[0]}, frees {mem1[1] - mem0[1]}")
    _log(f"window: {loop.chunks} chunks in {loop.window_s:.6f} s; "
         f"captures in the window: {ses.captures() - captures0}")

    runner = ses.runner
    ctx = Ctx(loop=tr["loop"], setup_s=setup_s,
              chunks=loop.chunks, window_s=loop.window_s,
              keyticks_per_chunk=ses.kt, latencies_s=loop.latencies_s,
              step_host_s=loop.step_host_s, chunk_bytes=ses.chunk_bytes,
              sparse=runner.policy.sparse, units=ses.K * runner.n_segs,
              shapes=ses.shapes)
    breakdown = None
    if trace:
        ctx.dirty = runner.dirty_stats()
        ctx.picks = _picks(runner)
        if ses.on_card:
            before = _picks(runner)
            box: list = []
            with trace_mod.profiled(box):
                st = ses.window(min(cell.trace_seconds, seconds),
                                spans=True)
            after = _picks(runner)
            ctx.trace = trace_mod.read(box[0])
            ctx.trace_chunks = st.chunks
            if before is not None:
                ctx.trace_picks = {k: after[k] - before[k] for k in after}
            breakdown = {
                "device_ops": [[k, v[0]] for k, v in sorted(
                    ctx.trace["kernels"].items(),
                    key=lambda kv: -kv[1][0])[:10]],
                "idle_gaps": trace_mod.top(ctx.trace["idle"])}
            _log(f"traced stretch: {st.chunks} chunks, window "
                 f"{ctx.trace['window_s']:.6f} s, busy "
                 f"{ctx.trace['busy_s']:.6f} s; picks {ctx.trace_picks}")
            for k, v in breakdown["device_ops"]:
                _log(f"  device {k}: {v:.6f} s")
            for k, v in breakdown["idle_gaps"]:
                _log(f"  idle while {k}: {v:.6f} s")

    metrics = {}
    for m in cell.metrics:
        v = _reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    peak = (int(torch.cuda.max_memory_allocated(dev)) if ses.on_card
            else 0)

    # -- the comparison, once the program's state is freed ----------------
    compared = keep.chunks()
    del runner
    gc.unfreeze()
    ses.free_program()
    worst, failed = ses.compare(compared)
    ok = bool(compared) and failed == 0
    checks = {n: {"value": worst[n], "limit": cfg["limits"][n]}
              for n in worst}
    _log(f"compared {len(compared)} chunks of the window (stream chunks "
         f"{[ci for ci, _ in compared]}), {failed} failed")

    result = {"correct": ok, "attempted": loop.chunks, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if ses.on_card else "cpu",
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": peak}}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace["busy_s"]
        result["device"]["window_s"] = ctx.trace["window_s"]
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return {"result": result, "checks": checks, "ok": ok}
