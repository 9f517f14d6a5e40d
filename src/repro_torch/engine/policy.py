"""Composable execution policies; port of ``repro.engine.policy``.

:class:`ExecPolicy` names the four orthogonal axes of chunked execution,
each resolved by its own planning artifact and all consumed by the one
runner (:mod:`repro_torch.engine.runner`):

====================  ======================  ===========================
axis                  values                  planning artifact
====================  ======================  ===========================
``body``              ``dense`` | ``sparse``  :class:`repro_torch.core.plan.ChangePlan`
``keys``              ``single`` | ``vmapped``  a leading key axis
``placement``         ``local`` | mesh(axis)  the work axis over a mesh axis
``dag``               ``solo`` | ``union``    :func:`repro_torch.core.plan.plan_union`
====================  ======================  ===========================

``placement`` shards the *work-unit* axis over one axis of a
:class:`torch.distributed.device_mesh.DeviceMesh` (one process per rank):
the key axis for ``keys='vmapped'`` (keys never communicate), the segment
axis for ``keys='single'`` (segments within a chunk are distributed, with
the chunk buffer replicated); the multi-hop chain of
:mod:`repro_torch.core.halo` remains the one-shot time-sharded path,
:func:`repro_torch.core.parallel.shard_map_run`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from torch.distributed.device_mesh import DeviceMesh

from ..launch.mesh import axis_rank, axis_size

__all__ = ["ExecPolicy", "MeshPlacement", "mesh_placement",
           "BODIES", "KEYS", "PLACEMENTS", "DAGS"]

BODIES = ("dense", "sparse")
KEYS = ("single", "vmapped")
PLACEMENTS = ("local", "mesh")
DAGS = ("solo", "union")


@dataclasses.dataclass(frozen=True)
class MeshPlacement:
    """``placement=mesh(axis)``: shard the policy's work axis along one
    named mesh axis (the key axis when ``keys='vmapped'``, the segment
    axis when ``keys='single'``)."""

    mesh: DeviceMesh
    axis: str = "data"

    def __repr__(self) -> str:  # keep policy repr readable in test output
        return f"mesh(axis={self.axis!r}, n={axis_size(self.mesh, self.axis)})"


def mesh_placement(mesh: DeviceMesh, axis: str = "data") -> MeshPlacement:
    """The ``mesh(axes)`` constructor for :class:`ExecPolicy.placement`."""
    return MeshPlacement(mesh, axis)


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """One point in the execution-policy space ``body × keys × placement ×
    dag``.  Pure configuration: validation against a concrete query
    (lookahead, divisibility, ChangePlan presence) happens when a
    :class:`repro_torch.engine.runner.Runner` is built from it."""

    body: str = "dense"
    keys: str = "single"
    placement: Union[str, MeshPlacement] = "local"
    dag: str = "solo"

    def __post_init__(self):
        if self.body not in BODIES:
            raise ValueError(f"body={self.body!r} not in {BODIES}")
        if self.keys not in KEYS:
            raise ValueError(f"keys={self.keys!r} not in {KEYS}")
        if self.dag not in DAGS:
            raise ValueError(f"dag={self.dag!r} not in {DAGS}")
        if isinstance(self.placement, DeviceMesh):
            # accept a bare mesh for convenience: mesh over its default axis
            object.__setattr__(
                self, "placement",
                MeshPlacement(self.placement,
                              self.placement.mesh_dim_names[0]))
        if self.placement != "local" and not isinstance(self.placement,
                                                        MeshPlacement):
            raise ValueError(
                f"placement={self.placement!r} must be 'local', a "
                "DeviceMesh, or mesh_placement(mesh, axis)")

    # -- accessors -----------------------------------------------------------
    @property
    def sparse(self) -> bool:
        return self.body == "sparse"

    @property
    def keyed(self) -> bool:
        return self.keys == "vmapped"

    @property
    def union(self) -> bool:
        return self.dag == "union"

    @property
    def mesh(self) -> Optional[DeviceMesh]:
        return (self.placement.mesh
                if isinstance(self.placement, MeshPlacement) else None)

    @property
    def axis(self) -> str:
        return (self.placement.axis
                if isinstance(self.placement, MeshPlacement) else "data")

    @property
    def n_shards(self) -> int:
        m = self.mesh
        return axis_size(m, self.axis) if m is not None else 1

    @property
    def rank(self) -> int:
        """This process's index along the placement's axis (0 when
        local)."""
        m = self.mesh
        return axis_rank(m, self.axis) if m is not None else 0

    def describe(self) -> str:
        """Compact ``dense×single×local×solo``-style label."""
        placement = ("local" if self.mesh is None
                     else f"mesh{self.n_shards}")
        return f"{self.body}×{self.keys}×{placement}×{self.dag}"
