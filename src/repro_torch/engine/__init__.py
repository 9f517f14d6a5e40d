"""Execution engine: one policy-driven runner for the chunked strategies
(port of ``repro.engine``).

:class:`Runner` advances a compiled TiLT query chunk by chunk under an
:class:`ExecPolicy` — ``body`` (dense | sparse) × ``keys`` (single |
vmapped) × ``placement`` (local | :func:`mesh_placement`) × ``dag`` (solo
| union) — around a single carried state pytree with one
checkpoint/restore/validate path, and re-runs sealed chunks on late data
(``enable_revision``/``revise``).
:class:`KeyedEngine` survives as a deprecated alias for
``Runner(exe, ExecPolicy(keys="vmapped"))``.
"""
from .keyed import KeyedEngine, keyed_grid, wrap_keyed_step
from .policy import ExecPolicy, MeshPlacement, mesh_placement
from .runner import BodySpec, Runner, body_spec_of

__all__ = ["KeyedEngine", "keyed_grid", "wrap_keyed_step", "ExecPolicy",
           "MeshPlacement", "mesh_placement", "BodySpec", "Runner",
           "body_spec_of"]
