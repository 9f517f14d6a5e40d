"""Structured analysis findings + schema-versioned JSONL export; port of
``repro.analysis.findings``.

Every pass in :mod:`repro_torch.analysis` reports :class:`Finding` records —
one per violation (or notable observation) with enough provenance to locate it:
which pass fired, at which policy-lattice point, on which audit target
(staged step / chunk variant / input name), and where inside the recorded
step program or planning artifact.  Severities gate CI:

* ``error``   — a proven violation of a hot-path invariant (a transfer,
  a dead donated leaf, a collective under divergent control, an
  under-captured staging key, an under-dilated change plan).
* ``warning`` — suspicious but not proven wrong (e.g. a donated leaf with
  no shape-matching output to alias into).
* ``info``    — observations (e.g. a halo wider than the derived demand:
  conservative, correct, but worth seeing).

The JSONL export mirrors the conventions of :mod:`repro_torch.obs.export`
(schema field on every record, append-lines format, a validator for the
round-trip) under the reference's schema tag ``repro.analysis/v1``, so one
reader takes both packages' findings.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List

__all__ = ["SCHEMA", "SEVERITIES", "Finding", "export_jsonl", "read_jsonl",
           "validate_finding", "verdict"]

SCHEMA = "repro.analysis/v1"
SEVERITIES = ("info", "warning", "error")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding (see module docstring for severity semantics).

    ``pass_name`` serializes as ``"pass"`` (a Python keyword).  ``target``
    names the audited object inside the policy point (a staged-step label
    like ``sparse_fused(steady)``, a chunk variant, or an input name);
    ``provenance`` locates the evidence (a frame path like
    ``step/body[4]/c10d._allgather_base_``, a state buffer path, or plan
    coordinates).
    """

    severity: str
    pass_name: str
    code: str
    message: str
    policy: str = ""
    target: str = ""
    provenance: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}")

    def to_json(self) -> Dict:
        return {"schema": SCHEMA, "severity": self.severity,
                "pass": self.pass_name, "code": self.code,
                "message": self.message, "policy": self.policy,
                "target": self.target, "provenance": self.provenance}

    @staticmethod
    def from_json(d: Dict) -> "Finding":
        return Finding(severity=d["severity"], pass_name=d["pass"],
                       code=d["code"], message=d["message"],
                       policy=d.get("policy", ""), target=d.get("target", ""),
                       provenance=d.get("provenance", ""))


def validate_finding(d: Dict) -> List[str]:
    """Schema problems of one JSON finding record (empty = valid)."""
    problems = []
    if d.get("schema") != SCHEMA:
        problems.append(f"schema is {d.get('schema')!r}, want {SCHEMA!r}")
    if d.get("severity") not in SEVERITIES:
        problems.append(f"severity {d.get('severity')!r} not in {SEVERITIES}")
    for field in ("pass", "code", "message"):
        if not isinstance(d.get(field), str) or not d.get(field):
            problems.append(f"missing/empty field {field!r}")
    return problems


def verdict(findings: Iterable[Finding]) -> str:
    """The worst severity present: ``clean`` / ``info`` / ``warning`` /
    ``error`` — the one-word audit result benchmarks embed next to their
    measurements."""
    worst = -1
    for f in findings:
        worst = max(worst, _RANK[f.severity])
    return "clean" if worst < 0 else SEVERITIES[worst]


def export_jsonl(findings: Iterable[Finding], path: str) -> str:
    """Write findings as JSON lines (one record per line, every record
    schema-tagged — the same append-friendly shape as
    :func:`repro_torch.obs.export.export_jsonl`)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for f in findings:
            fh.write(json.dumps(f.to_json(), sort_keys=True) + "\n")
    return path


def read_jsonl(path: str) -> List[Finding]:
    """Read back an :func:`export_jsonl` file, validating each record."""
    out = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            problems = validate_finding(d)
            if problems:
                raise ValueError(f"{path}:{i + 1}: {'; '.join(problems)}")
            out.append(Finding.from_json(d))
    return out
