"""Activation-sharding hints, decoupled from model code (port of
``repro.models.shardctx``).

Entry points (the dry-run, the trainer on a mesh) declare the mesh once with
:func:`set_mesh_axes`; model code puts :func:`hint` on the activations
whose layout the propagation tends to get wrong without help (logits over
vocab, hidden states over batch, MoE's expert buffers).  With no mesh
declared, or on a tensor that is not a ``DTensor``, a hint is the
identity, so every CPU and single-card path keeps its exact bits and its
captured graphs.

A hint is ``DTensor.redistribute`` to the placements its names give, the
counterpart of ``jax.lax.with_sharding_constraint``: ``"dp"`` is the
declared data-parallel group ``("pod", "data")``, a mesh axis name shards
the tensor dimension it stands at over that axis, and a name the mesh
lacks (or ``None``) leaves it replicated.  Where two names of one hint
would put two tensor dimensions on one mesh axis, the first keeps it, as
one mesh axis may appear once in a ``PartitionSpec``.

:func:`scope` is what the model's entry points run under: while a mesh is
declared, a plain tensor that meets a ``DTensor`` (positions, masks, rope
tables, zeros the model makes) counts as replicated on its mesh
(``implicit_replication``); without one it does nothing.
"""
from __future__ import annotations

import contextlib
import math
import sys
from typing import Optional, Sequence

import torch

__all__ = ["set_mesh_axes", "clear", "hint", "placements", "scope",
           "is_sharded", "batch_axes", "model_axis", "replicated", "linear"]

_DP: Optional[tuple] = None
_AXES: Optional[tuple] = None
_MESH = None


def set_mesh_axes(axes: Sequence[str], mesh=None) -> None:
    """Declare the mesh's axis names, e.g. ``("pod", "data", "model")``,
    and the ``DeviceMesh`` they name (the reference reads the ambient
    ``with mesh:``; here the mesh is registered beside its axes)."""
    global _DP, _AXES, _MESH
    _AXES = tuple(axes)
    _DP = tuple(a for a in ("pod", "data") if a in _AXES) or None
    _MESH = mesh


def clear() -> None:
    global _DP, _AXES, _MESH
    _DP = _AXES = _MESH = None


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a tensor laid over a mesh).  No
    ``DTensor`` exists before its module is imported, so a path that
    never meets one never imports it."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def batch_axes(mesh, n: int):
    """The spec entry of a batch dimension of ``n`` rows on ``mesh``: all
    its data-parallel axes (``("pod", "data")``) where they divide ``n``,
    else ``"data"`` alone where it does, else ``None`` (the guard of
    ``launch.sharding.batch_sharding_for``)."""
    names = mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    size = {a: mesh.size(names.index(a)) for a in dp}
    if dp and n % math.prod(size.values()) == 0:
        return dp
    if "data" in size and n % size["data"] == 0:
        return "data"
    return None


def placements(names: Sequence, mesh) -> list:
    """The ``DTensor`` placements (one per mesh dimension, in mesh order)
    of a spec whose entry ``d`` is the mesh axis, tuple of axes or
    ``None`` for tensor dimension ``d``: ``Shard(d)`` on each named axis,
    ``Replicate()`` on the rest.  A tuple entry shards one dimension over
    several axes, the first outermost, as JAX orders them.  ``mesh`` is a
    ``DeviceMesh``, an ``{axis: size}`` dict or the axis names; an axis of
    size 1 splits nothing and is left replicated (DTensor's views refuse
    to merge or drop a dimension sharded even one way)."""
    from torch.distributed.tensor import Replicate, Shard
    if isinstance(mesh, dict):
        axes, sizes = tuple(mesh), mesh
    elif isinstance(mesh, (tuple, list)):
        axes, sizes = tuple(mesh), {}
    else:
        axes = tuple(mesh.mesh_dim_names)
        sizes = {a: mesh.size(i) for i, a in enumerate(axes)}
    out = [Replicate() for _ in axes]
    for d, entry in enumerate(names):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            if sizes.get(a, 2) > 1:
                out[axes.index(a)] = Shard(d)
    return out


def _model_split(w, mesh) -> Optional[int]:
    """The dimension of ``w`` laid over ``model``, if any."""
    names = mesh.mesh_dim_names
    if "model" not in names or not is_sharded(w):
        return None
    p = w.placements[names.index("model")]
    return p.dim if p.is_shard() else None


def model_axis(mesh, n: int) -> Optional[str]:
    """``"model"`` where the mesh has that axis and it divides ``n`` (a
    count of heads, experts or vocab rows), else ``None``."""
    names = mesh.mesh_dim_names
    if "model" in names and n % mesh.size(names.index("model")) == 0:
        return "model"
    return None


def replicated(t, mesh):
    """``t`` as a ``DTensor`` on ``mesh``: itself if it is one, else
    replicated (as :func:`scope` treats a plain tensor)."""
    if is_sharded(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def linear(x, w):
    """``x (..., D) @ w (D, F)`` (``torch.matmul``).  On a mesh the product
    is laid out as Megatron's tensor parallelism, from the weight's own
    layout on ``model``: x's rows over the batch axes, the weight gathered
    over its FSDP axis; a weight split on F (column-parallel) gives an
    output split on F, one split on D (row-parallel) takes x split on D
    and its partial sums are all-reduced.  Each rank multiplies its own
    blocks (``local_map``), so the backward's layouts are these too: the
    weight's gradient partial over the batch axes, x's partial over
    ``model`` where the weight is column-parallel.  (DTensor's own choice
    for a batched product can split the flattened (batch, time) rows over
    ``model``, which later views, or a gradient arriving laid out as a
    sequence-parallel residual, cannot take apart.)"""
    if not (is_sharded(x) or is_sharded(w)):
        return torch.matmul(x, w)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    m = (x if is_sharded(x) else w).device_mesh
    batch = batch_axes(m, x.shape[0])
    split = _model_split(w, m)
    mid = (None,) * (x.dim() - 2)
    if split == 0:          # row-parallel
        xs, ws, ys = (batch, *mid, "model"), ("model", None), (batch,)
    elif split == 1:        # column-parallel
        xs, ws, ys = (batch, *mid, None), (None, "model"), (
            batch, *mid, "model")
    else:
        xs, ws, ys = (batch, *mid, None), (None, None), (batch,)
    xp, wp, yp, rows = (placements(xs, m), placements(ws, m),
                        placements(ys, m), placements((batch,), m))
    on_model = [n == "model" for n in m.mesh_dim_names]
    # the weight's gradient sums over this rank's rows: partial on the
    # batch axes; x's over this rank's columns of a split F: partial on
    # model; a row-parallel output is partial on model until reduced
    wg = [Partial() if r.is_shard() else p for r, p in zip(rows, wp)]
    xg = [Partial() if split == 1 and mm and p.is_shard() else q
          for mm, p, q in zip(on_model, wp, xp)]
    if split == 0:
        yp = [Partial() if mm and p.is_shard() else q
              for mm, p, q in zip(on_model, wp, yp)]
    y = local_map(torch.matmul, out_placements=yp,
                  in_placements=(xp, wp), in_grad_placements=(xg, wg),
                  device_mesh=m, redistribute_inputs=True)(
        replicated(x, m), replicated(w, m))
    if split == 0:
        y = y.redistribute(m, rows)
    return y


def hint(x, *names):
    """Constrain ``x``'s layout; names are mesh axes, ``"dp"`` or None."""
    if _AXES is None or _MESH is None or not is_sharded(x):
        return x
    used, spec = set(), []
    for n in names:
        if n == "dp":
            n = tuple(a for a in _DP or () if a not in used) or None
        elif n not in _AXES or n in used:
            n = None
        used.update((n,) if isinstance(n, str) else n or ())
        spec.append(n)
    want = placements(spec, _MESH)
    if tuple(x.placements) == tuple(want):
        return x
    return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def scope():
    """DTensor's implicit replication while a mesh is declared; nothing
    otherwise.  Scopes nest (``implicit_replication()`` itself switches
    the flag off when any one exits, and a loss's scope sits inside the
    gradient's, whose backward recomputes rematerialized layers)."""
    if _MESH is None:
        yield
        return
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev
