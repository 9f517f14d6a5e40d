"""Static hot-path auditor + temporal-plan verifier
(``repro_torch.analysis``); port of ``repro.analysis``.

TiLT's core claim is that a time-centric IR is *analyzable*: temporal
bounds and lineage are static, which is what makes optimization and
parallelization passes safe.  This package turns the port's hardest
invariants — no synchronizing call and one captured graph per steady
chunk, state written in place, collectives never inside a compacted body,
a step cache keyed on everything a step is built for, halo/dilation
contracts covering the IR's true demand — from runtime test assertions
into checks over the **recorded step programs** (:mod:`.graphs`) and the
planning artifacts, audited across the 16-point ExecPolicy lattice.

Entry points:

* ``python -m repro_torch.analysis`` — CLI over the lattice (on CUDA
  unless ``--device cpu``); findings land in ``out/analysis.jsonl``.
* :func:`audit_runner` — audit one live runner.
* :data:`PASSES` — the registry; a new pass is a function
  ``AuditTarget -> [Finding]`` added here.
"""
from .audit import (PASSES, audit_lattice, audit_runner,
                    build_lattice_runner, lattice_policies)
from .findings import (SCHEMA, SEVERITIES, Finding, export_jsonl,
                       read_jsonl, validate_finding, verdict)
from .passes import AuditTarget, make_target

__all__ = ["PASSES", "audit_lattice", "audit_runner",
           "build_lattice_runner", "lattice_policies",
           "SCHEMA", "SEVERITIES", "Finding", "export_jsonl", "read_jsonl",
           "validate_finding", "verdict", "AuditTarget", "make_target"]
