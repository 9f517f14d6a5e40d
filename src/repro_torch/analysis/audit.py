"""Pass manager: audit one runner, or the whole 16-point policy lattice;
port of ``repro.analysis.audit``.

``audit_runner`` runs every registered pass over one runner's audit
surface; ``audit_lattice`` builds a representative runner per
:class:`repro_torch.engine.ExecPolicy` point — every combination of
body(dense|sparse) × keys(single|vmapped) × placement(local|mesh) ×
dag(solo|union), the matrix the reference audits — and audits each.
The mesh points run on a 1-rank mesh
(:func:`repro_torch.launch.mesh.make_local_mesh`: gloo on the CPU, NCCL on
the card; the gathers and the steps' frames are all there whatever the
rank count), so the full lattice audits on one device.

The audit queries mirror the hot-path tests: a windowed-mean trend/join
query per solo point, plus a second band query for union points, compiled
``sparse=True`` so every point (dense bodies included) carries a
ChangePlan for the temporal-plan verifier.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..core import compile as qc
from ..core.frontend import TStream
from ..engine import ExecPolicy, Runner, mesh_placement
from ..launch.mesh import make_local_mesh
from ..multiquery import union_runner
from .findings import Finding
from .passes import (AuditTarget, make_target, pass_collectives,
                     pass_donation, pass_recompile, pass_revision,
                     pass_serving, pass_transfers)
from .planverify import pass_plan

__all__ = ["PASSES", "audit_runner", "audit_lattice", "lattice_policies",
           "build_lattice_runner", "SEG", "SPC", "N_KEYS"]

# every registered pass, in report order
PASSES: Dict[str, Callable[[AuditTarget], List[Finding]]] = {
    "transfer": pass_transfers,
    "donation": pass_donation,
    "collective": pass_collectives,
    "recompile": pass_recompile,
    "plan": pass_plan,
    "revision": pass_revision,
    "serving": pass_serving,
}

# default audit geometry (small: the lattice audits in seconds on the CPU)
SEG = 16     # output ticks per segment
SPC = 4      # segments per chunk
N_KEYS = 4   # keyed points


def audit_runner(runner: Runner, policy: Optional[str] = None,
                 passes: Optional[Dict] = None, device=None
                 ) -> List[Finding]:
    """Run every (or the given) passes over one runner, on ``device``
    (default: the runner's, :meth:`Runner.audit_example_chunks`)."""
    target = make_target(runner, policy, device)
    out: List[Finding] = []
    for fn in (passes if passes is not None else PASSES).values():
        out.extend(fn(target))
    return out


# ---------------------------------------------------------------------------
# the policy lattice
# ---------------------------------------------------------------------------

def _trend(keyed: bool):
    s = TStream.source("in", prec=1, keyed=keyed)
    return (s.window(8).mean()
            .join(s.window(16).mean(), lambda a, b: a - b)
            .where(lambda d: d > 0))


def _bands(keyed: bool):
    s = TStream.source("in", prec=1, keyed=keyed)
    return s.window(16).mean().select(lambda m: m * 2.0)


def lattice_policies(device=None) -> List[ExecPolicy]:
    """All 16 points of body × keys × placement × dag; the mesh points on
    a 1-rank mesh over ``device`` (CUDA unless ``"cpu"`` is asked for).
    A process's default group serves one backend, so CPU and CUDA mesh
    points do not mix in one process."""
    mesh = mesh_placement(make_local_mesh(device=device))
    pts = []
    for body in ("dense", "sparse"):
        for keys in ("single", "vmapped"):
            for placement in ("local", mesh):
                for dag in ("solo", "union"):
                    pts.append(ExecPolicy(body=body, keys=keys,
                                          placement=placement, dag=dag))
    return pts


def build_lattice_runner(policy: ExecPolicy, *, seg: int = SEG,
                         spc: int = SPC, n_keys: int = N_KEYS) -> Runner:
    """A representative runner at one policy point (the audit target the
    CLI and the lattice tests share).  Queries are compiled sparse so a
    ChangePlan is always present for the plan verifier; dense bodies
    simply don't consume it.  A runner follows the device of its chunks:
    the audit's ``device`` places it."""
    keyed = policy.keyed
    nk = n_keys if keyed else None
    if policy.union:
        return union_runner(
            {"trend": _trend(keyed), "bands": _bands(keyed)}, span=seg,
            policy=policy, n_keys=nk, segs_per_chunk=spc)
    exe = qc.compile_query(_trend(keyed).node, out_len=seg, sparse=True)
    return Runner(exe, policy, n_keys=nk, segs_per_chunk=spc)


def audit_lattice(policies: Optional[List[ExecPolicy]] = None,
                  passes: Optional[Dict] = None, device=None
                  ) -> List[Finding]:
    """Audit every policy point (default: the full 16-point lattice) on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    out: List[Finding] = []
    for policy in (policies if policies is not None
                   else lattice_policies(device)):
        r = build_lattice_runner(policy)
        out.extend(audit_runner(r, passes=passes, device=device))
    return out
