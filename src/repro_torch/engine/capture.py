"""CUDA-graph capture of the runner's chunk steps.

On a CUDA device every chunk step of :class:`repro_torch.engine.runner.
Runner` runs as a captured graph: the step reads the runner's static
buffers (the chunk is copied into them, never rebound) and writes its
state back into them in place, so one capture serves every later chunk of
the same (variant, bucket) key.  Capture replaces the reference's staged
``jit`` executables; nothing selects it but the tensors' device, and a
capture that fails raises (there is no eager fallback on the card).

* :func:`warm_up` runs a step once eagerly on a side stream before its
  first capture (over a scratch copy of the buffers, so the live state is
  untouched): it loads the kernel library, sets kernel attributes and fills
  every per-device cache, none of which may happen inside a capture.
* :func:`record` captures a step into a ``torch.cuda.CUDAGraph`` in the
  runner's memory pool, with PyTorch's default ``capture_error_mode=
  "global"``, so an unsafe call inside a step fails loudly.
* :class:`Switched` is the switched step of the runner's sparse chunks
  and of :class:`StagedSwitch`: a prefix (which leaves a count on the
  device), one body per capacity and a suffix, run eagerly with the count
  read on the host, or captured and composed into one graph whose body a
  kernel picks on the device (``csrc/graph_switch.cu``): a sparse chunk
  reads nothing on the host.
* :class:`Staged` stages a pure function as the reference's ``jax.jit``
  stages it, for the one-shot paths (``CompiledQuery.fn``,
  ``partition_run``, ``batch_run``, ``shard_map_run``, ``shard_union_run``):
  one captured graph per input geometry, over static input buffers the
  arguments are copied into, its outputs copied out.

Under a mesh (``placement=mesh``) a step ends with NCCL all-gathers of
its results (``engine.runner._gather_packed``): they are captured in the
graph like any kernel (PyTorch captures NCCL collectives), so a replay
issues no collective from the host; the collector stays off during
capture as for every step.

Frames.  The parts of a step are marked with :func:`frame`: ``step``
(the runner's) around what one captured graph replays on the card, inside
it a switched step's ``prefix``, ``bucket-pick`` (the CPU's host read of
the dirty count), ``body[cap]`` (one capacity's compacted body) and
``suffix`` (:meth:`Switched.run_eager`), and ``after`` (a mesh step's
graph of its own).  :func:`frames` is the stack
the calling thread is in; the static audit (:mod:`repro_torch.analysis`)
reads it for every operation it records.  A frame costs a list push and
pop; a replay pushes none.

Launch counts.  A replay runs no kernel wrapper, so the wrappers' launch
counts (``window_reduce.launches`` and the others, and the copies
``window_reduce.copies`` counts) would not move.  A capture therefore
records the launches its step issued and every replay adds them; of a
switched step's bodies exactly one runs, and all of them issue the same
launches (checked at composition).  Launches issued while a
step warms up or is being captured compute no result of the path and are
not counted.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import gc
import threading
from typing import Callable, List, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..buckets import pick
from ..device import resolve
from ..kernels import (fused_query, region_program, sparse_compact,
                       window_reduce)
from ..kernels.build import launch_stream, library

__all__ = ["Captured", "Frame", "STAGED_CACHE_MAX", "Spec", "Staged",
           "Switched", "StagedSwitch", "frame", "frames", "geometry",
           "record", "replays", "warm_up"]

# bound on the input geometries one Staged function keeps captured: a
# graph holds its memory pool, which a jit cache entry does not
STAGED_CACHE_MAX = 8

_COUNTS = (window_reduce.launches, window_reduce.copies,
           sparse_compact.launches, fused_query.launches,
           region_program.launches, region_program.copies)


# graph replays, by kind ("graph": one captured graph launched): the
# static audit counts the graphs one steady chunk replays
replays: collections.Counter = collections.Counter()


class Frame:
    """One part of a step the calling thread is in (compared by identity:
    two entries of one part are two frames)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name


_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


@contextlib.contextmanager
def frame(name: str):
    """Mark the code it encloses as the part ``name`` of a step."""
    st = _stack()
    st.append(Frame(name))
    try:
        yield
    finally:
        st.pop()


def frames() -> Tuple[Frame, ...]:
    """The frames the calling thread is in, outermost first."""
    return tuple(_stack())


def _counts() -> list:
    return [dict(c) for c in _COUNTS]


def _restore(snap: list) -> None:
    for c, s in zip(_COUNTS, snap):
        c.update(s)


def _delta(before: list, after: list) -> list:
    return [{k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
            for b, a in zip(before, after)]


def _add(delta: Sequence[dict]) -> None:
    for c, d in zip(_COUNTS, delta):
        for k, n in d.items():
            c[k] += n


@contextlib.contextmanager
def warm_up(device: torch.device):
    """Run the body eagerly on a side stream, ordered after the current
    stream's work and before its next; its launches are not counted."""
    snap = _counts()
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        cur.wait_stream(side)
        _restore(snap)


class Captured:
    """One captured step: its graph, the tensors its capture returned
    (static: every replay rewrites them) and the launches it holds."""

    def __init__(self, graph, result, launches: list):
        self.graph, self.result, self.launches = graph, result, launches

    def replay(self):
        self.graph.replay()
        _add(self.launches)
        replays["graph"] += 1
        return self.result


def record(step: Callable[[], object], pool, *, keep: bool = False
           ) -> Captured:
    """Capture ``step()`` into a new graph in ``pool``.  ``keep=True``
    keeps the graph uninstantiated for :class:`Switched` to compose."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    snap = _counts()
    # no garbage collection while capturing: collecting another runner's
    # graph frees its memory pool, and a free on any thread invalidates a
    # capture in "global" mode
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            result = step()
        launches = _delta(snap, _counts())
    finally:
        _restore(snap)
        if collecting:
            gc.enable()
    return Captured(graph, result, launches)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


class Switched:
    """The switched step as one graph: ``prefix`` (which leaves the count
    in ``count``), then the body :func:`~repro_torch.buckets.pick` picks
    over ``caps``, then
    ``suffix``.  The pick runs on the device; :meth:`replay` returns the
    suffix's result.  The parts, ``(prefix, bodies, suffix)``, are called
    as ``part(state)`` over one static state: the prefix leaves the int32
    count in ``state.cnt``, and ``state.caps`` holds the capacities (int64,
    on the device)."""

    @classmethod
    def run_eager(cls, parts, state, caps: Sequence[int], *,
                  every: bool = False):
        """The parts one after another, each in its frame, the suffix's
        result returned: the host reads the count and runs the body it
        picks, or with ``every`` every body in turn, as the composed graph
        holds them (a warm-up before :meth:`compose`)."""
        prefix, bodies, suffix = parts
        with frame("prefix"):
            prefix(state)
        if every:
            picked = range(len(bodies))
        else:
            with frame("bucket-pick"):
                picked = (pick(int(state.cnt), caps),)
        for i in picked:
            with frame(f"body[{caps[i]}]"):
                bodies[i](state)
        with frame("suffix"):
            return suffix(state)

    @classmethod
    def compose(cls, parts, state, pool, shared=None) -> "Switched":
        """The parts captured (kept) in ``pool`` and composed; ``shared``:
        the bodies and suffix captured already (another switched step's
        over the same state)."""
        prefix, bodies, suffix = parts
        head = record(lambda: prefix(state), pool, keep=True)
        if shared is None:
            shared = ([record(lambda b=b: b(state), pool, keep=True)
                       for b in bodies],
                      record(lambda: suffix(state), pool, keep=True))
        return cls(head, *shared, state.cnt, state.caps)

    def __init__(self, prefix: Captured, bodies: List[Captured],
                 suffix: Captured, count: torch.Tensor, caps: torch.Tensor):
        lib = library.load()
        if len(bodies) > lib.gs_max_bodies():
            raise ValueError(f"{len(bodies)} capacity buckets exceed the "
                             f"{lib.gs_max_bodies()} a switched step takes")
        if any(b.launches != bodies[0].launches for b in bodies):
            raise RuntimeError("the compacted bodies issue different "
                               "launches; a replay could not count them")
        if caps.dtype != torch.int64 or count.dtype != torch.int32:
            raise TypeError("count must be int32 and caps int64")
        self._parts = (prefix, bodies, suffix, count, caps)
        self.shared = (bodies, suffix)
        self.result = suffix.result
        self.launches = [
            {k: p.get(k, 0) + b.get(k, 0) + s.get(k, 0)
             for k in {*p, *b, *s}}
            for p, b, s in zip(prefix.launches, bodies[0].launches,
                               suffix.launches)]
        self._dev = count.device
        graphs = (ctypes.c_void_p * len(bodies))(
            *[b.graph.raw_cuda_graph() for b in bodies])
        out = ctypes.c_void_p()
        _check(lib.gs_compose(prefix.graph.raw_cuda_graph(), graphs,
                              len(bodies), suffix.graph.raw_cuda_graph(),
                              count.data_ptr(), caps.data_ptr(),
                              self._dev.index, launch_stream(self._dev),
                              ctypes.byref(out)),
               "composing the switched sparse step")
        self._exec = out.value
        self._lib = lib

    def replay(self):
        _check(self._lib.gs_launch(self._exec, self._dev.index,
                                   launch_stream(self._dev)),
               "launching the switched sparse step")
        _add(self.launches)
        replays["graph"] += 1
        return self.result

    def __del__(self):
        exe = getattr(self, "_exec", None)
        if exe:
            self._lib.gs_destroy(exe)


# ---------------------------------------------------------------------------
# staged functions: the one-shot paths' counterpart of ``jax.jit``
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Spec:
    """A tensor argument of a staged call given by its geometry alone, for
    callers that write the entry's buffer themselves (a pytree leaf)."""

    device: torch.device
    shape: tuple
    dtype: torch.dtype


def _is_arg(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, Spec)


def geometry(args) -> tuple:
    """What a staged function is captured for: the tree structure of
    ``args``, each tensor leaf's (or :class:`Spec`'s) device, shape and
    dtype, and every other leaf itself (a static argument, as ``jit``'s).
    Strides are not part of it: the static buffers are contiguous, so the
    graph never sees the caller's layout."""
    leaves, spec = tree_flatten(args)
    return (spec, tuple(
        (x.device, tuple(x.shape), x.dtype) if _is_arg(x)
        else ("static", x) for x in leaves))


def _device_of(leaves) -> torch.device:
    """The device a staged call runs on: its tensors' (one device), else a
    ``torch.device`` among its static arguments, else the port's default
    (CUDA, or raise where there is none)."""
    devs = {x.device for x in leaves if _is_arg(x)}
    if len(devs) > 1:
        raise ValueError(f"a staged call's tensors lie on several devices: "
                         f"{sorted(map(str, devs))}")
    if devs:
        return devs.pop()
    dev = next((x for x in leaves if isinstance(x, torch.device)), None)
    return resolve(dev)


class StagedEntry:
    """One geometry of a :class:`Staged` function: static input buffers
    (``inputs``, the arguments' tree with every tensor replaced by a
    contiguous buffer of its shape and dtype) and, on the card, the graph
    of ``fn(*inputs)`` in a memory pool of its own, captured at the first
    :meth:`run` after an eager warm-up on a side stream."""

    def __init__(self, fn: Callable, args: tuple, dev: torch.device):
        self.fn, self.dev = fn, dev
        leaves, self._spec = tree_flatten(args)
        self._slots = [i for i, x in enumerate(leaves) if _is_arg(x)]
        bufs = list(leaves)
        for i in self._slots:
            bufs[i] = torch.zeros(leaves[i].shape, dtype=leaves[i].dtype,
                                  device=dev)
        self.buffers = [bufs[i] for i in self._slots]
        self.inputs = tree_unflatten(bufs, self._spec)
        self._graph = None
        self._pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                      else None)

    def load(self, args) -> None:
        """Copy the tensors of ``args`` (this entry's geometry) into the
        buffers."""
        leaves = tree_flatten(args)[0]
        for dst, i in zip(self.buffers, self._slots):
            dst.copy_(leaves[i])

    def run(self):
        """``fn`` over the buffers: eagerly on the CPU, a replay of the
        captured graph on the card.  The outputs are static: the next run
        of this entry overwrites them (and on the CPU they may be views of
        the buffers), so copy what is kept before that."""
        if self.dev.type != "cuda":
            return self.fn(*self.inputs)
        if self._graph is None:
            with warm_up(self.dev):
                self.fn(*self.inputs)
            self._graph = record(lambda: self.fn(*self.inputs), self._pool)
        return self._graph.replay()

    @property
    def captured(self) -> bool:
        return self._graph is not None


class Staged:
    """``fn`` (a pure function of tensor trees) staged per input geometry,
    as ``jax.jit`` stages it.  A call finds the :class:`StagedEntry` of
    its arguments' :func:`geometry` (bounded LRU, ``STAGED_CACHE_MAX``; an
    evicted entry frees its graph and pool), copies the arguments into its
    buffers, runs it (on the card one graph replay) and returns copies of
    the outputs, which no later call overwrites.  On the CPU the same
    plumbing runs ``fn`` eagerly.  A capture that fails raises and leaves
    no entry behind: nothing falls back to eager on the card.

    Callers that fill the buffers themselves (a partition's window) take
    :meth:`entry`, with :class:`Spec` leaves where tensors would go, and
    write ``entry.inputs``."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.entries: "collections.OrderedDict[tuple, StagedEntry]" = \
            collections.OrderedDict()
        self.captures = 0

    def entry(self, *args) -> StagedEntry:
        """The entry of ``args``' geometry (tensors or :class:`Spec`
        leaves), built on its first use (its buffers hold zeros until
        loaded)."""
        key = geometry(args)
        hit = self.entries.get(key)
        if hit is not None:
            self.entries.move_to_end(key)
            return hit
        while len(self.entries) >= STAGED_CACHE_MAX:
            self.entries.popitem(last=False)
        hit = self._make(args, _device_of(tree_flatten(args)[0]))
        hit.key = key
        self.entries[key] = hit
        return hit

    def _make(self, args, dev: torch.device) -> StagedEntry:
        return StagedEntry(self.fn, args, dev)

    def run(self, ent: StagedEntry):
        """``ent.run()``, counting its capture; an entry whose capture
        failed is dropped before the error propagates."""
        fresh = ent.dev.type == "cuda" and not ent.captured
        try:
            out = ent.run()
        except BaseException:
            if fresh:
                self.entries.pop(ent.key, None)
            raise
        self.captures += fresh
        return out

    def __call__(self, *args):
        ent = self.entry(*args)
        ent.load(args)
        return tree_map(lambda x: x.clone() if torch.is_tensor(x) else x,
                        self.run(ent))


def _copy_into(dst, src) -> None:
    for d, x in zip(tree_flatten(dst)[0], tree_flatten(src)[0]):
        d.copy_(x)


class _SwitchEntry(StagedEntry):
    """One geometry of a :class:`StagedSwitch`: the input buffers, the
    count and the capacities, and the :class:`Switched` parts over them.
    The prefix leaves ``mid`` and the count here, and every body copies
    its output into ``out``, the one buffer the suffix reads (made again
    before a capture, outside the graph's pool: it lives with the entry)."""

    def __init__(self, parts, args, dev):
        super().__init__(None, args, dev)
        prefix, bodies, suffix, self.ladder = parts
        self.caps = torch.as_tensor(self.ladder, dtype=torch.int64,
                                    device=dev)
        self.cnt = torch.zeros((), dtype=torch.int32, device=dev)
        self.mid = self.out = None

        def pre(s):
            s.mid, count = prefix(*s.inputs)
            s.cnt.copy_(count)

        def body(b):
            def run(s):
                out = b(s.mid)
                if s.out is None:
                    s.out = tree_map(torch.zeros_like, out)
                _copy_into(s.out, out)
            return run

        self.switch = (pre, [body(b) for b in bodies],
                       lambda s: suffix(s.out, s.cnt))

    def run(self):
        if self.dev.type != "cuda":
            return Switched.run_eager(self.switch, self, self.ladder)
        if self._graph is None:
            with warm_up(self.dev):
                Switched.run_eager(self.switch, self, self.ladder,
                                   every=True)
            self.mid, self.out = None, tree_map(torch.zeros_like, self.out)
            self._graph = Switched.compose(self.switch, self, self._pool)
        return self._graph.replay()


class StagedSwitch(Staged):
    """A staged function whose middle is picked by a count on the device,
    as the reference's ``lax.switch`` inside one ``jit``:
    ``prefix(*args) -> (mid, count)`` (``count`` an int32 0-d tensor),
    then ``bodies[b](mid)`` for ``b`` the :func:`~repro_torch.buckets.pick`
    of the count over ``caps``, then ``suffix(outs, count)``; every
    body returns the same tree of shapes.  Staged per input geometry as
    :class:`Staged`: on the card one :class:`Switched` graph, whose body a
    kernel picks, so a call reads nothing on the host; on the CPU the
    parts run eagerly and the count is read on the host.  All bodies must
    issue the same kernel launches (:class:`Switched` checks it)."""

    def __init__(self, prefix: Callable, bodies: Sequence[Callable],
                 suffix: Callable, caps: Sequence[int]):
        super().__init__(None)
        self.parts = (prefix, list(bodies), suffix, list(caps))

    def _make(self, args, dev: torch.device) -> StagedEntry:
        return _SwitchEntry(self.parts, args, dev)
