"""``python -m repro_torch.analysis`` — audit the policy lattice from the
shell (port of ``python -m repro.analysis``).

Runs every registered pass over every point of the 16-point ExecPolicy
lattice (or a ``--policy``-filtered subset) on ``--device`` (CUDA unless
``cpu`` is asked for; without a card and without ``--device cpu`` it
raises), prints a per-(policy, pass) summary table plus one line per
finding, writes the findings as schema-versioned JSONL (default
``out/analysis.jsonl``), and exits non-zero when findings at or above
``--fail-on`` exist.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

from .audit import PASSES, audit_lattice, lattice_policies
from .findings import SEVERITIES, export_jsonl, verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static hot-path auditor + temporal-plan verifier "
                    "over the ExecPolicy lattice.")
    ap.add_argument("--fail-on", choices=list(SEVERITIES) + ["never"],
                    default="error",
                    help="exit 1 when findings at/above this severity "
                         "exist (default: error)")
    ap.add_argument("--json", action="store_true",
                    help="print findings as JSON lines to stdout instead "
                         "of the human table")
    ap.add_argument("--out", default="out/analysis.jsonl",
                    help="findings JSONL path (default: out/analysis.jsonl)")
    ap.add_argument("--policy", default=None,
                    help="substring filter on the policy label "
                         "(e.g. 'sparse×vmapped' or 'mesh')")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass subset "
                         f"(available: {','.join(PASSES)})")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    passes = None
    if args.passes:
        unknown = [p for p in args.passes.split(",") if p not in PASSES]
        if unknown:
            ap.error(f"unknown passes {unknown}; available: {list(PASSES)}")
        passes = {p: PASSES[p] for p in args.passes.split(",")}
    policies = [p for p in lattice_policies(args.device)
                if args.policy is None or args.policy in p.describe()]
    if not policies:
        ap.error(f"--policy {args.policy!r} matches no lattice point")

    findings = audit_lattice(policies, passes=passes, device=args.device)
    path = export_jsonl(findings, args.out)

    if args.json:
        for f in findings:
            print(json.dumps(f.to_json(), sort_keys=True))
    else:
        names = list(passes if passes is not None else PASSES)
        print(f"audited {len(policies)} policy points × "
              f"{len(names)} passes ({', '.join(names)})")
        by = Counter((f.severity for f in findings))
        for f in findings:
            print(f"  [{f.severity:7s}] {f.pass_name}/{f.code} "
                  f"@ {f.policy or '-'} :: {f.target or '-'} — {f.message}")
        counts = " ".join(f"{s}={by.get(s, 0)}" for s in SEVERITIES)
        print(f"verdict: {verdict(findings)} ({counts}) → {path}")

    if args.fail_on == "never":
        return 0
    threshold = SEVERITIES.index(args.fail_on)
    bad = [f for f in findings if SEVERITIES.index(f.severity) >= threshold]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
