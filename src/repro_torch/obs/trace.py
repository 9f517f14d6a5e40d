"""Phase tracing: wall-time span trees, an event recorder with chunk events
on the card, and a recompile detector; port of ``repro.obs.trace``.

Spans answer "where does the wall time go" at phase granularity —
plan / compile / execute / refit — without a profiler run.  ``span()``
is a context manager; nesting builds slash-separated paths
(``session.rebuild/plan``), and each path aggregates count / total / max
seconds.  This is *host* wall time around dispatch boundaries: spans
never touch device values, so they are safe anywhere, including around
the sync-checked hot path.

The recorder.  Between :meth:`Tracer.start_recording` and
:meth:`Tracer.stop_recording` every span also becomes one :class:`Event`
(path, start and end on ``time.perf_counter_ns``, the index of its parent
event, the chunk's sequence number) in a buffer allocated when recording
starts; events past its end are counted in :attr:`Tracer.dropped`, and
the buffer never grows.  ``Runner.step`` records itself only while the
recorder is on (``runner.step`` and its parts ``ingest``, ``load``,
``launch``, ``copy_out``, ``grids``: one chunk id); off, it pays one flag
check a chunk.  While recording under an active ``torch.profiler``, each
span also opens ``torch.profiler.record_function(path)``, so the
profile shows the runner's parts on the card's timeline.

Chunk events on the card.  Started with a CUDA ``device``, the recorder
also keeps a pool of timing CUDA events, made and anchored to the host
clock when recording starts (a synchronize, then an event recorded on
the empty stream beside one host clock read); a step records one just
before its copy-in and one just after its copy-out.
:meth:`Tracer.device_chunks` (one synchronize, off the hot path) gives
each chunk's device interval on the host clock, and
:meth:`Tracer.idle_gaps` the gaps between them, each labelled by the
innermost span the host was in at its midpoint.  The anchor's alignment
error (an event recorded on the idle card after a synchronize, its
device stamp on the host clock less the host clock read just before the
record, 100 records) on an H100 80GB HBM3 at 700 W: medians 0.6 and 3.6 us just after the anchor, -1.6 and
5.0 us 2.3 s after it, quartiles within 7 us, single records up to 71
us (the host descheduled between its read and the record).

The recompile detector rides the engine's own staging discipline: every
miss in ``Runner``'s ``step_cache`` (one built step per (policy,
geometry) point) calls :meth:`Tracer.record_compile` with the cache key.
A key built **more than once** means the cache was dropped and rebuilt —
an unexpected rebuild; :meth:`Tracer.retraces` surfaces exactly those.
On the card a runner also captures each step's CUDA graph once, at its
first use: :meth:`Tracer.record_capture` counts captures per label where
the reference counts compiles (each inside a ``runner.capture`` span),
and a steady state records none.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

__all__ = ["Tracer", "Event", "DeviceChunk", "Gap", "OUTSIDE",
           "SPANS_A_CHUNK"]

OUTSIDE = "outside the program"   # a gap's label where no span was open

# events a Runner.step records a chunk (``runner.step`` and its five
# parts): a caller sizes the buffer by it, and the chunk event pool is
# sized so it runs out no sooner than the buffer
SPANS_A_CHUNK = 6


class Event(NamedTuple):
    """One recorded span.  ``end_ns`` is 0 while it is open; ``parent`` is
    the index of its parent event (-1 for none recorded), ``chunk`` the
    sequence number of the chunk it belongs to (-1 outside a chunk)."""
    path: str
    start_ns: int
    end_ns: int
    parent: int
    chunk: int


class DeviceChunk(NamedTuple):
    """One chunk's interval on the card, on the host clock."""
    chunk: int
    start_ns: int
    end_ns: int


class Gap(NamedTuple):
    """The card idle between one chunk's end and the next one's start,
    labelled by the innermost span open on the host at its midpoint."""
    start_ns: int
    end_ns: int
    label: str


class Tracer:
    """Aggregating span recorder, event recorder + per-key compile
    counter."""

    def __init__(self):
        # open spans: (path, start_ns, event index, chunk, profiler range,
        # the end list of the buffer the event is in)
        self._stack: List[tuple] = []
        self._paths: Dict[tuple, str] = {}
        self._spans: Dict[str, Dict] = {}
        self._compiles: Dict[str, int] = {}
        self._captures: Dict[str, int] = {}
        self._aot: Dict[str, str] = {}
        self.recording = False
        self.dropped = 0
        self._cap = self._n = self._seq = 0
        self._path: list = []
        self._t0: list = []
        self._t1: list = []
        self._parent: list = []
        self._chunk: list = []
        self._dev = self._anchor = None
        self._anchor_ns = 0
        self._pool: list = []
        self._pool_chunk: list = []
        self._n_dev = 0
        self._dev_open = -1

    # -- spans -------------------------------------------------------------
    def open(self, name: str, *, chunk: bool = False) -> int:
        """Open the span ``name`` inside the innermost open one; ``chunk``
        starts a new chunk id for it and its children.  Returns the token
        :meth:`close` takes."""
        return self._open(name, time.perf_counter_ns(), chunk)

    def _open(self, name: str, t: int, chunk: bool = False) -> int:
        st = self._stack
        top = st[-1] if st else None
        parent = top[0] if top else ""
        path = self._paths.get((parent, name))
        if path is None:
            path = self._paths[(parent, name)] = (
                f"{parent}/{name}" if parent else name)
        ev, cid, rf, ends = -1, -1, None, None
        if self.recording:
            if chunk:
                self._seq += 1
                cid = self._seq
            elif top is not None:
                cid = top[3]
            ev = self._n
            if ev < self._cap:
                self._n += 1
                ends = self._t1
                self._path[ev], self._t0[ev], self._t1[ev] = path, t, 0
                self._parent[ev] = top[2] if top is not None else -1
                self._chunk[ev] = cid
            else:
                self.dropped += 1
                ev = -1
            if _profiler._is_profiler_enabled:
                rf = torch.profiler.record_function(path)
                rf.__enter__()
        st.append((path, t, ev, cid, rf, ends))
        return len(st) - 1

    def close(self, token: Optional[int] = None) -> int:
        """Close the innermost open span, or with ``token`` every span
        from the one :meth:`open` returned it for inward (those a raise
        left open first).  Returns the last closed span's nanoseconds."""
        t = time.perf_counter_ns()
        depth = len(self._stack) - 1 if token is None else token
        dt = 0
        while len(self._stack) > depth:
            dt = self._close(t)
        return dt

    def _close(self, t: int) -> int:
        path, t0, ev, _cid, rf, ends = self._stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        if ev >= 0:
            ends[ev] = t
        dt = t - t0
        s = self._spans.get(path)
        if s is None:
            s = self._spans[path] = {"count": 0, "total_s": 0.0,
                                     "max_s": 0.0}
        s["count"] += 1
        s["total_s"] += dt / 1e9
        s["max_s"] = max(s["max_s"], dt / 1e9)
        return dt

    def next(self, name: str) -> None:
        """Close the innermost open span and open its sibling ``name``, on
        one clock read."""
        t = time.perf_counter_ns()
        self._close(t)
        self._open(name, t)

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a phase.  Nested spans build ``outer/inner`` paths."""
        token = self.open(name)
        try:
            yield
        finally:
            self.close(token)

    # -- the recorder ------------------------------------------------------
    def start_recording(self, capacity: int = 1 << 16, device=None) -> None:
        """Record every span as an :class:`Event`, up to ``capacity`` of
        them.  With a CUDA ``device``, also make the chunk events' pool and
        anchor it to the host clock (this synchronizes the card)."""
        if capacity < 1:
            raise ValueError(f"capacity must be positive, not {capacity}")
        self._cap, self._n, self.dropped = int(capacity), 0, 0
        self._path = [""] * self._cap
        self._t0, self._t1 = [0] * self._cap, [0] * self._cap
        self._parent, self._chunk = [-1] * self._cap, [-1] * self._cap
        self._dev = self._anchor = None
        self._pool, self._pool_chunk = [], []
        self._n_dev, self._dev_open = 0, -1
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            n = self._cap // SPANS_A_CHUNK + 1
            self._pool = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for _ in range(n)]
            for a, b in self._pool:     # made here, not in a step
                a.record(stream)
                b.record(stream)
            self._pool_chunk = [-1] * n
            self._anchor = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            self._anchor_ns = time.perf_counter_ns()
            self._anchor.record(stream)
            self._dev = dev
        self.recording = True

    def stop_recording(self) -> None:
        """Stop recording; the events stay readable until the next
        :meth:`start_recording`."""
        self.recording = False

    def chunk_start(self) -> None:
        """Record the current chunk's start event on the card's current
        stream (a step calls it while recording, before its copy-in)."""
        if self._dev is None:
            return
        i = self._n_dev
        if i >= len(self._pool):
            self.dropped += 1
            return
        self._pool[i][0].record(torch.cuda.current_stream(self._dev))
        self._pool_chunk[i] = self._stack[-1][3] if self._stack else -1
        self._dev_open = i

    def chunk_end(self) -> None:
        """Record the current chunk's end event (after its copy-out)."""
        i = self._dev_open
        if i < 0:
            return
        self._pool[i][1].record(torch.cuda.current_stream(self._dev))
        self._n_dev, self._dev_open = i + 1, -1

    def events(self) -> List[Event]:
        """The recorded events, in the order they opened."""
        return [Event(*e) for e in zip(
            self._path[:self._n], self._t0[:self._n], self._t1[:self._n],
            self._parent[:self._n], self._chunk[:self._n])]

    def self_times(self, events: Optional[List[Event]] = None
                   ) -> Dict[str, int]:
        """Each path's nanoseconds over ``events`` (default: the recorded
        ones) less the part its children cover.  Open events count
        nothing."""
        evs = self.events() if events is None else events
        own = [e.end_ns - e.start_ns if e.end_ns else 0 for e in evs]
        for e, d in zip(evs, list(own)):
            if e.parent >= 0 and e.end_ns:
                own[e.parent] -= d
        out: Dict[str, int] = {}
        for e, d in zip(evs, own):
            if e.end_ns:
                out[e.path] = out.get(e.path, 0) + d
        return out

    def device_chunks(self) -> List[DeviceChunk]:
        """Each recorded chunk's start and end on the card, on the host
        clock (the anchor's host time plus the device's elapsed time).
        Synchronizes the card once; empty without chunk events."""
        if self._dev is None or not self._n_dev:
            return []
        torch.cuda.synchronize(self._dev)
        at = self.on_host_clock
        return [DeviceChunk(c, at(s), at(e))
                for (s, e), c in zip(self._pool[:self._n_dev],
                                     self._pool_chunk)]

    def on_host_clock(self, event) -> int:
        """A completed timing CUDA event, recorded on the card since
        recording started, as nanoseconds of ``time.perf_counter_ns``."""
        return self._anchor_ns + round(self._anchor.elapsed_time(event)
                                       * 1e6)

    def idle_gaps(self, chunks: Optional[List[DeviceChunk]] = None,
                  events: Optional[List[Event]] = None) -> List[Gap]:
        """The gaps between consecutive chunks on the card, each labelled
        by the innermost recorded span open on the host at its midpoint
        (``runner.step/load``, say), or :data:`OUTSIDE`."""
        chunks = self.device_chunks() if chunks is None else chunks
        evs = self.events() if events is None else events
        order = sorted((e.start_ns, i) for i, e in enumerate(evs)
                       if e.end_ns)
        starts = [s for s, _ in order]
        gaps = []
        for a, b in zip(chunks, chunks[1:]):
            mid = (a.end_ns + b.start_ns) // 2
            label = OUTSIDE
            # back from the latest span started by the midpoint: the
            # first that is still open is the innermost; a top-level one
            # that has ended closes the search (spans nest)
            j = bisect.bisect_right(starts, mid) - 1
            while j >= 0:
                e = evs[order[j][1]]
                if e.end_ns > mid:
                    label = e.path
                    break
                if e.parent < 0:
                    break
                j -= 1
            gaps.append(Gap(a.end_ns, b.start_ns, label))
        return gaps

    # -- compiles and captures ----------------------------------------------
    def record_compile(self, key: str) -> None:
        """Note a step-cache miss at a policy point (a step built)."""
        self._compiles[key] = self._compiles.get(key, 0) + 1

    def record_capture(self, key: str) -> None:
        """Note a CUDA graph captured for a runner's step (its first use
        on the card, or an ahead-of-time capture)."""
        self._captures[key] = self._captures.get(key, 0) + 1

    def captures(self) -> Dict[str, int]:
        return dict(self._captures)

    def record_aot(self, key: str, how: str = "captured") -> None:
        """Note a step prepared ahead of the first chunk under its key
        (``how``: ``"captured"`` for a CUDA graph, ``"eager"`` for a step
        built to run eagerly on the CPU)."""
        self._aot[key] = how

    def aot_installs(self) -> Dict[str, str]:
        return dict(self._aot)

    def compiles(self) -> Dict[str, int]:
        return dict(self._compiles)

    def retraces(self) -> Dict[str, int]:
        """Keys compiled more than once — unexpected retraces: the
        runner's step_cache holds exactly one step per key, so a second
        compile means the cache was dropped and the step re-staged."""
        return {k: n - 1 for k, n in self._compiles.items() if n > 1}

    def retrace_findings(self) -> List[Dict]:
        """The runtime retrace record in static-finding form: one entry
        per key compiled more than once, shaped like a
        ``repro.analysis`` finding payload (the recompile-hazard pass
        merges these with its static probe, so a runtime-observed retrace
        and a statically-proven under-keyed cache land in one report)."""
        return [{"severity": "error", "code": "runtime-retrace",
                 "message": (f"staging key {k!r} compiled {n + 1} times — "
                             "the step cache was dropped or under-keyed"),
                 "provenance": k}
                for k, n in sorted(self.retraces().items())]

    def span_report(self) -> Dict[str, Dict]:
        return {k: dict(v) for k, v in sorted(self._spans.items())}

    def compile_report(self) -> Dict:
        return {"counts": self.compiles(), "retraces": self.retraces(),
                "aot_installs": self.aot_installs()}

    def reset(self) -> None:
        self._spans.clear()
        self._compiles.clear()
        self._captures.clear()
        self._aot.clear()
        self._stack.clear()
