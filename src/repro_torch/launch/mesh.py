"""Device meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dims, the counterpart of ``jax.sharding.Mesh``: one process per rank, and
every rank calls the same entry point with the same arguments, as a JAX
program is written once for all shards.  One axis's process group is
``mesh.get_group(axis)``, its size :func:`axis_size` and the calling
rank's index along it :func:`axis_rank` (``jax.lax.axis_index``).

:class:`AxisComm` is what the SPMD paths communicate through: one axis's
group, its size and this rank's index, with the two collectives the TiLT
paths need — one hop of a neighbour chain (:meth:`AxisComm.hop`, the
``ppermute`` of the halo exchange) and an all-gather along a tensor axis
(:meth:`AxisComm.all_gather`).  On the card the group is NCCL's, on the
CPU gloo's.

Axis semantics (as the reference's):

* ``pod``   — slowest axis, data parallelism across pods only.
* ``data``  — data parallel and TiLT stream-time / key sharding.
* ``model`` — tensor parallel.
"""
from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve

__all__ = ["AxisComm", "axis_comm", "axis_rank", "axis_size",
           "group_serial", "make_local_mesh", "make_production_mesh",
           "merge_ranks", "mesh_device"]

TIMEOUT = datetime.timedelta(seconds=60)
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
_meshes: dict = {}
# id(group) -> (group, serial); holding the group keeps its id from being
# reused by a later group
_serials: dict = {}


def group_serial(group) -> int:
    """A number that names ``group`` for the life of the process: two
    groups never share one, whether they span the same ranks or one was
    destroyed and another started in its place.  Caches of built steps
    (which communicate through a group) and of meshes key on it."""
    hit = _serials.get(id(group))
    if hit is None:
        hit = _serials[id(group)] = (group, len(_serials))
    return hit[1]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production shapes and axis names (``(16, 16)`` over
    ``("data", "model")``, or ``(2, 16, 16)`` with a ``pod`` axis), over
    the ranks of the default process group (for the dry-run, a ``fake``
    group of 256 or 512 ranks in one process), built only when called."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(n_data: Optional[int] = None, n_model: int = 1,
                    device=None) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks of the default process
    group (``n_data`` defaults to ``world_size // n_model``) on ``device``
    (CUDA unless ``"cpu"`` is asked for).

    Where no process group exists, this starts a 1-rank one over an
    in-memory store — NCCL on ``cuda`` (the calling process's current
    card), gloo on ``cpu`` — the mesh over whatever devices exist, as in
    the reference.  An existing group is reused and never torn down, and
    the mesh of one shape is made once per group (a default group
    destroyed and started again gets meshes of its own).  A new mesh is warmed
    with one all-reduce on each axis, so NCCL's communicators exist before
    the first point-to-point batch or graph capture."""
    dev = resolve(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
        dist.init_process_group(_BACKENDS[dev.type], store=dist.HashStore(),
                                rank=0, world_size=1, timeout=TIMEOUT)
    backend = str(dist.get_backend())
    if _BACKENDS[dev.type] not in backend:
        raise ValueError(
            f"the default process group runs {backend!r}, which does not "
            f"serve {dev.type} tensors (want {_BACKENDS[dev.type]!r})")
    world = dist.get_world_size()
    n_data = n_data or world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) does not cover the "
                         f"{world} ranks of the default process group")
    key = (group_serial(dist.group.WORLD), n_data, n_model, dev.type)
    mesh = _meshes.get(key)
    if mesh is None:
        mesh = init_device_mesh(dev.type, (n_data, n_model),
                                mesh_dim_names=("data", "model"))
        for axis in mesh.mesh_dim_names:
            dist.all_reduce(torch.zeros(1, device=mesh_device(mesh)),
                            group=mesh.get_group(axis))
        _meshes[key] = mesh
    return mesh


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of ``mesh`` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (``mesh.shape[axis]`` of the
    reference)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


class AxisComm:
    """One mesh axis as the SPMD paths see it: its process group, its
    size ``n``, this rank's index ``rank`` along it, and the group's
    :func:`group_serial` ``serial`` (what step caches key on)."""

    def __init__(self, group, rank: int, n: int, device: torch.device):
        self.group, self.rank, self.n, self.device = group, rank, n, device
        self.serial = group_serial(group)

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def hop(self, tensors: Sequence[torch.Tensor], left: bool
            ) -> List[torch.Tensor]:
        """One hop of a neighbour chain (``jax.lax.ppermute``): every rank
        sends ``tensors`` one rank up the axis (``left``: they become the
        receiver's left neighbour's data) or one rank down, and receives
        its neighbour's, in one ``batch_isend_irecv``.  A rank with no
        neighbour to receive from gets zeros (φ: zero value, ``False``
        validity), as ``ppermute`` leaves non-participating receivers."""
        dst = self.rank + 1 if left else self.rank - 1
        src = self.rank - 1 if left else self.rank + 1
        recv = [torch.zeros_like(t) for t in tensors]
        ops = []
        if 0 <= dst < self.n:
            ops += [dist.P2POp(dist.isend, t.contiguous(), self._peer(dst),
                               self.group) for t in tensors]
        if 0 <= src < self.n:
            ops += [dist.P2POp(dist.irecv, r, self._peer(src), self.group)
                    for r in recv]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return recv

    def gather_flat(self, x: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every rank's ``x`` stacked on a new leading axis ``(n, *x.shape)``
        (into ``out`` when given: one collective, no host read)."""
        if out is None:
            out = torch.empty((self.n,) + tuple(x.shape), dtype=x.dtype,
                              device=x.device)
        # both flat: the concatenated form every backend takes
        dist.all_gather_into_tensor(out.view(-1), x.contiguous().view(-1),
                                    group=self.group)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated in rank order along ``dim``: the
        global array a reference caller reads back from a result sharded
        ``P(axis)`` along that dim."""
        return merge_ranks(self.gather_flat(x), dim)


def merge_ranks(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``(n, *shape)`` per-rank parts → one tensor concatenated in rank
    order along ``dim`` of ``shape``."""
    dim = dim % (x.dim() - 1)
    x = x.movedim(0, dim)
    return x.reshape(x.shape[:dim] + (-1,) + x.shape[dim + 2:])


def axis_comm(mesh, axis: str = "data") -> AxisComm:
    """The :class:`AxisComm` of ``mesh``'s ``axis`` (``mesh`` may already
    be one, and is then returned as it is)."""
    if isinstance(mesh, AxisComm):
        return mesh
    return AxisComm(mesh.get_group(axis), axis_rank(mesh, axis),
                    axis_size(mesh, axis), mesh_device(mesh))
