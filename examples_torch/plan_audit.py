"""Static hot-path audit walkthrough on the PyTorch port: prove a runner
clean, then break it.

Builds a sparse keyed runner, audits it with every `repro_torch.analysis`
pass (transfer-freedom and one captured graph a chunk, state written in
place, collective placement, recompile hazard, temporal-plan verification)
over the step programs it records, and prints the clean verdict.  Then
deliberately under-dilates the query's ChangePlan — the "silently stale
outputs" bug class — and shows the temporal-plan verifier catch it from
the independently re-derived IR demand, with the offending segments
named.

The same machinery runs over the full 16-point ExecPolicy lattice as
`python -m repro_torch.analysis` (the gate); findings land in
`out/analysis.jsonl` as schema-versioned JSONL (`repro.analysis/v1`).

Run:  PYTHONPATH=src python examples_torch/plan_audit.py [--device cpu]

Without ``--device`` it runs on the CUDA card (and raises without one).
The findings land in ``out/example_audit.jsonl`` under the working
directory.
"""
import argparse
import dataclasses

from repro_torch import device as D
from repro_torch.analysis import (AuditTarget, audit_runner, export_jsonl,
                                  verdict)
from repro_torch.analysis.planverify import derive_bounds, pass_plan
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.engine import ExecPolicy, Runner
from repro_torch.engine.runner import body_spec_of

SEG = 32
SPC = 4
K = 8


def make_query():
    s = TStream.source("in", prec=1, keyed=True)
    return (s.window(16).mean()
            .join(s.window(32).mean(), lambda a, b: a - b)
            .where(lambda d: d > 0))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)

    exe = qc.compile_query(make_query().node, out_len=SEG, sparse=True)
    r = Runner(exe, ExecPolicy(body="sparse", keys="vmapped"), n_keys=K,
               segs_per_chunk=SPC)

    # 1. the full audit: every pass over the runner's recorded steps
    findings = audit_runner(r, device=dev)
    print(f"shipped runner: verdict={verdict(findings)} "
          f"({len(findings)} findings, device {D.name(dev)})")
    for f in findings:
        print(f"  [{f.severity}] {f.pass_name}/{f.code}: {f.message}")

    # 2. the verifier's independent demand derivation (vs the planner's)
    req = derive_bounds(exe.root if isinstance(exe.root, tuple)
                        else (exe.root,))
    s = exe.input_specs["in"]
    print(f"derived demand for 'in': (lookback, lookahead) = {req['in']} "
          f"time units; planned halo contract serves {s.contract_t()}")

    # 3. break the plan: halve the dilation, watch the verifier object
    spec = body_spec_of(exe)
    cp = spec.change_plan
    halved = dataclasses.replace(cp, specs={
        name: dataclasses.replace(sp, lookback=sp.lookback // 2)
        for name, sp in cp.specs.items()})
    bad_spec = dataclasses.replace(spec, change_plan=halved, step_cache={})
    bad = Runner(bad_spec, ExecPolicy(body="sparse", keys="vmapped"),
                 n_keys=K, segs_per_chunk=SPC)
    bad_findings = pass_plan(AuditTarget(
        runner=bad, policy="example:under-dilated", steps=[],
        chunk_variants=(), device=dev))
    print(f"\nunder-dilated plan: verdict={verdict(bad_findings)}")
    for f in bad_findings:
        print(f"  [{f.severity}] {f.pass_name}/{f.code}: {f.message}")

    path = export_jsonl(bad_findings, "out/example_audit.jsonl")
    print(f"\nfindings exported → {path}")
    return {"verdict": verdict(findings), "findings": findings,
            "demand": req["in"], "contract": s.contract_t(),
            "bad_verdict": verdict(bad_findings),
            "bad_findings": bad_findings, "path": path}


if __name__ == "__main__":
    main()
