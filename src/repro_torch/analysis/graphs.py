"""Recording a runner's step program for the static passes; the port's
counterpart of ``repro.analysis.jaxprs``.

The reference walks the jaxpr of a traced step.  PyTorch runs eagerly and
has no jaxpr, so the program is recorded instead: :func:`record` runs a
step (or a whole-chunk function) once, eagerly, under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode`, and keeps one
:class:`Site` per aten or c10d operation it dispatches.  It never runs
during a CUDA-graph capture: what it records is the program a capture
would hold, run over a scratch workspace (``Runner.staged_steps``).

A site's ``path`` is the stack of frames the runner pushed around it
(:func:`repro_torch.engine.capture.frame`), the counterpart of the
reference's nesting of eqns under ``pjit``/``cond``:

* ``step``: what one captured graph replays on the card (the staged
  region, the reference's ``pjit``); ``after``, inside a ``step`` of its
  own, the hold or gather a mesh step replays as a second graph.
* ``prefix``, ``suffix``: the sparse step's change detection and its hold
  fill and state write.
* ``bucket-pick``: the host read of the dirty count that picks the
  capacity on the CPU (on the card a device kernel picks it, and the
  recording runs every capacity's body in turn, as the switched graph
  holds them all).
* ``body[cap]``: one capacity's compacted body.  Divergent, the
  reference's ``cond``: ranks compact apart, so they can run different
  bodies.

Each site also keeps the storages the operation reads and writes.  Writes
come from the schema's alias information (``is_write``); the c10d
schemas carry none, so a collective's output (its first argument) is
taken as written.  A view, or another operation that moves no data, reads
nothing.  Kernels launched through ``ctypes`` are not operations of the
dispatcher and are not seen; the tensors they read and write are made,
viewed and consumed by operations that are.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, FrozenSet, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..engine import capture
from ..engine.capture import Frame

__all__ = ["Site", "record", "storage_key", "DIVERGENT", "STEP", "SYNCS"]

STEP = "step"
DIVERGENT = "body["          # frames whose name starts with this diverge

# operations that wait for the device and read a value on the host
SYNCS = frozenset({"_local_scalar_dense", "nonzero", "is_nonzero", "equal"})

# operations that move no data but are not tagged as views
_METADATA = frozenset({"_unsafe_view", "lift_fresh", "detach", "alias",
                       "_reshape_alias"})

# mutations that overwrite their target without reading it
_OVERWRITE = frozenset({"copy_", "fill_", "zero_"})

_COLLECTIVES = ("c10d", "_c10d_functional")


def storage_key(t: torch.Tensor) -> tuple:
    """What names a tensor's memory across its views."""
    return (t.device.type, t.device.index, t.untyped_storage().data_ptr())


@dataclasses.dataclass(frozen=True)
class Site:
    """One dispatched operation, the frames it ran in and the storages it
    read and wrote."""

    op: str                       # namespace.name, e.g. "aten.add_"
    path: Tuple[Frame, ...]
    reads: FrozenSet[tuple]
    writes: FrozenSet[tuple]
    metadata: bool                # a view: moves no data
    to_host: bool                 # copies a device tensor to the host

    @property
    def name(self) -> str:
        return self.op.split(".", 1)[1]

    @property
    def collective(self) -> bool:
        return self.op.split(".", 1)[0] in _COLLECTIVES

    @property
    def syncs(self) -> bool:
        """Waits for the device and reads its result on the host."""
        return self.name in SYNCS or self.to_host

    def frame(self, name: str) -> Optional[Frame]:
        """The outermost frame called ``name`` above this site."""
        return next((f for f in self.path if f.name == name), None)

    def divergent_frames(self) -> Tuple[Frame, ...]:
        """The divergent frames above this site (empty: it runs on every
        rank)."""
        return tuple(f for f in self.path if f.name.startswith(DIVERGENT))

    def provenance(self) -> str:
        return "/".join([f.name for f in self.path] + [self.op])


def _tensors(v) -> list:
    return [x for x in tree_leaves(v)
            if isinstance(x, torch.Tensor) and x.numel()]


def _site(func, args, kwargs, out) -> Site:
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    metadata = bool(getattr(func, "is_view", False)) or name in _METADATA
    reads, writes, ins = set(), set(), []
    collective = ns in _COLLECTIVES
    for i, a in enumerate(func._schema.arguments):
        if i < len(args) and not a.kwarg_only:
            v = args[i]
        elif a.name in kwargs:
            v = kwargs[a.name]
        else:
            continue
        ts = _tensors(v)
        ins += ts
        written = a.alias_info is not None and a.alias_info.is_write
        if collective and i == 0 and name not in ("send",):
            written = True                # the collective's output
        if written:
            writes.update(map(storage_key, ts))
        overwritten = written and (a.kwarg_only or name in _OVERWRITE or (
            collective and ("gather" in name or name.startswith("recv"))))
        if not (metadata or overwritten):
            reads.update(map(storage_key, ts))
    outs = _tensors(out)
    to_host = (any(t.device.type != "cpu" for t in ins)
               and any(t.device.type == "cpu"
                       for t in outs + [t for t in ins
                                        if storage_key(t) in writes]))
    return Site(op=f"{ns}.{name}", path=capture.frames(),
                reads=frozenset(reads), writes=frozenset(writes),
                metadata=metadata, to_host=to_host)


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.sites: List[Site] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.sites.append(_site(func, args, kwargs, out))
        return out


def record(fn: Callable, *args) -> Tuple[object, List[Site]]:
    """``fn(*args)`` run once, eagerly, under the recorder: its result and
    the :class:`Site` of every operation it dispatched, in order."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the recorder runs a step eagerly, never inside "
                           "a CUDA-graph capture")
    rec = _Recorder()
    with rec:
        res = fn(*args)
    return res, rec.sites
