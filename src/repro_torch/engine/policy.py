"""Composable execution policies; port of ``repro.engine.policy``.

:class:`ExecPolicy` names the four orthogonal axes of chunked execution,
each resolved by its own planning artifact and all consumed by the one
runner (:mod:`repro_torch.engine.runner`):

====================  ======================  ===========================
axis                  values                  planning artifact
====================  ======================  ===========================
``body``              ``dense`` | ``sparse``  :class:`repro_torch.core.plan.ChangePlan`
``keys``              ``single`` | ``vmapped``  a leading key axis
``placement``         ``local`` | mesh(axis)  (ROADMAP A14: not ported)
``dag``               ``solo`` | ``union``    :func:`repro_torch.core.plan.plan_union`
====================  ======================  ===========================

The port runs ``placement="local"``; ``"mesh"`` is named by the policy (so
validation matches the reference) and raises ``NotImplementedError``
naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ExecPolicy", "BODIES", "KEYS", "PLACEMENTS", "DAGS"]

BODIES = ("dense", "sparse")
KEYS = ("single", "vmapped")
PLACEMENTS = ("local", "mesh")
DAGS = ("solo", "union")


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """One point in the execution-policy space ``body × keys × placement ×
    dag``.  Pure configuration: validation against a concrete query
    (lookahead, ChangePlan presence) happens when a
    :class:`repro_torch.engine.runner.Runner` is built from it."""

    body: str = "dense"
    keys: str = "single"
    placement: str = "local"
    dag: str = "solo"

    def __post_init__(self):
        if self.body not in BODIES:
            raise ValueError(f"body={self.body!r} not in {BODIES}")
        if self.keys not in KEYS:
            raise ValueError(f"keys={self.keys!r} not in {KEYS}")
        if self.dag not in DAGS:
            raise ValueError(f"dag={self.dag!r} not in {DAGS}")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement={self.placement!r} not in "
                             f"{PLACEMENTS}")
        if self.placement != "local":
            raise NotImplementedError(
                "placement='mesh' (sharding over devices) is not ported "
                "yet: ROADMAP A14")

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

    def describe(self) -> str:
        """Compact ``dense×single×local×solo``-style label."""
        return f"{self.body}×{self.keys}×local×{self.dag}"
