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
* :class:`Switched` composes the sparse step from its captured parts (the
  prefix, one compacted body per capacity, the suffix) into one graph
  whose bucket is picked on the device (``csrc/graph_switch.cu``): a
  sparse chunk reads nothing on the host.

Under a mesh (``placement=mesh``) a step ends with NCCL all-gathers of
its results (``engine.runner._gather_packed``): they are captured in the
graph like any kernel (PyTorch captures NCCL collectives), so a replay
issues no collective from the host; the collector stays off during
capture as for every step.

Frames.  The runner marks the parts of a step with :func:`frame`: ``step``
around what one captured graph replays on the card, inside it
``prefix``, ``bucket-pick`` (the CPU's host read of the dirty count),
``body[cap]`` (one capacity's compacted body) and ``suffix``, and
``after`` (a mesh step's graph of its own).  :func:`frames` is the stack
the calling thread is in; the static audit (:mod:`repro_torch.analysis`)
reads it for every operation it records.  A frame costs a list push and
pop; a replay pushes none.

Launch counts.  A replay runs no kernel wrapper, so the wrappers' launch
counts (``window_reduce.launches`` and the others) would not move.  A
capture therefore records the launches its step issued and every replay
adds them; of a switched step's bodies exactly one runs, and all of them
issue the same launches (checked at composition).  Launches issued while a
step warms up or is being captured compute no result of the path and are
not counted.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import threading
from typing import Callable, List, Sequence, Tuple

import torch

from ..kernels import fused_query, sparse_compact, window_reduce
from ..kernels.build import launch_stream, library

__all__ = ["Captured", "Frame", "Switched", "frame", "frames", "record",
           "replays", "warm_up"]

_COUNTS = (window_reduce.launches, sparse_compact.launches,
           fused_query.launches)


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
    """The sparse step as one graph: ``prefix`` (which leaves the dirty
    count in ``count``), then the body whose capacity is the first of
    ``caps`` at or above the count (the last past the end), then
    ``suffix``.  The pick runs on the device; :meth:`replay` returns the
    suffix's result."""

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
