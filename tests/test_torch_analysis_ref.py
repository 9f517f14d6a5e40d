"""The port's analysis against the reference's (``repro.analysis``) on the
same inputs: one findings format, and the same arithmetic.

* A reference-written findings file reads and validates with the port's
  reader, and the other way round (one schema tag, ``repro.analysis/v1``).
* The temporal-plan verifier: ``derive_bounds`` of queries built through
  both frontends from one seed, and the findings of ``pass_plan`` and
  ``pass_revision`` (code, severity, target, provenance) over runners of
  both packages — solo and union queries, a halved-lookback ChangePlan,
  revision rings undeclared, undersized and covered — are identical.
"""
import dataclasses

import numpy as np
import pytest

from repro.analysis import Finding as RFinding
from repro.analysis import export_jsonl as r_export_jsonl
from repro.analysis import read_jsonl as r_read_jsonl
from repro.analysis.passes import AuditTarget as RTarget
from repro.analysis.passes import pass_revision as r_pass_revision
from repro.analysis.planverify import derive_bounds as r_derive_bounds
from repro.analysis.planverify import pass_plan as r_pass_plan
from repro.core import compile as rqc
from repro.core.frontend import TStream as RTStream
from repro.engine import ExecPolicy as RPolicy, Runner as RRunner
from repro.engine.runner import body_spec_of as r_body_spec_of
from repro.multiquery import union_runner as r_union_runner
from repro_torch.analysis import Finding, export_jsonl, read_jsonl
from repro_torch.analysis import validate_finding
from repro_torch.analysis.passes import AuditTarget, pass_revision
from repro_torch.analysis.planverify import derive_bounds, pass_plan
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.engine import ExecPolicy, Runner
from repro_torch.engine.runner import body_spec_of
from repro_torch.multiquery import union_runner

SEG = 32
SPC = 4
SEEDS = range(6)


def _query(ts, seed: int):
    """A lookback-only query drawn from ``seed``: a chain of windows,
    shifts and maps over one source, joined with a shifted window of a
    second source at precision 2 (the same draw for either frontend)."""
    rng = np.random.default_rng(seed)
    a, b = ts.source("in", prec=1), ts.source("px", prec=2)
    x = a
    for _ in range(int(rng.integers(2, 5))):
        k = int(rng.integers(4))
        if k == 0:
            x = x.window(int(rng.integers(2, 24))).mean()
        elif k == 1:
            x = x.shift(int(rng.integers(1, 6)))
        elif k == 2:
            x = x.window(int(rng.integers(2, 12))).max()
        else:
            x = x.select(lambda v: v * 2.0)
    y = b.shift(int(rng.integers(1, 4)))
    y = y.window(2 * int(rng.integers(1, 8))).sum()
    return x.join(y, lambda p, q: p - q).where(lambda d: d > 0)


def _union(ts, seed: int):
    return {f"q{i}": _query(ts, seed * 7 + i) for i in range(3)}


def _key(findings):
    return [(f.code, f.severity, f.target, f.provenance) for f in findings]


def _halved(spec):
    cp = spec.change_plan
    return dataclasses.replace(spec, step_cache={}, change_plan=(
        dataclasses.replace(cp, specs={
            n: dataclasses.replace(sp, lookback=sp.lookback // 2)
            for n, sp in cp.specs.items()})))


def _plan_findings(r, rr):
    return (_key(pass_plan(AuditTarget(runner=r, policy="p", steps=[],
                                       chunk_variants=()))),
            _key(r_pass_plan(RTarget(runner=rr, policy="p", steps=[],
                                     chunk_variants=()))))


def test_reference_jsonl_reads_in_the_port_and_back(tmp_path):
    rf = [RFinding("error", "plan", "halo-undersized", "m", policy="p",
                   target="in", provenance="left_halo=3"),
          RFinding("info", "revision", "revision-horizon-covered", "n")]
    path = r_export_jsonl(rf, str(tmp_path / "ref.jsonl"))
    back = read_jsonl(path)
    assert [f.to_json() for f in back] == [f.to_json() for f in rf]
    assert all(validate_finding(f.to_json()) == [] for f in back)
    path = export_jsonl([Finding(**dataclasses.asdict(f)) for f in rf],
                        str(tmp_path / "port.jsonl"))
    assert r_read_jsonl(path) == rf


@pytest.mark.parametrize("seed", SEEDS)
def test_derive_bounds_equals_reference(seed):
    assert derive_bounds((_query(TStream, seed).node,)) == \
        r_derive_bounds((_query(RTStream, seed).node,))
    qs, rqs = _union(TStream, seed), _union(RTStream, seed)
    assert derive_bounds(tuple(q.node for q in qs.values())) == \
        r_derive_bounds(tuple(q.node for q in rqs.values()))


@pytest.mark.parametrize("halve", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_pass_plan_equals_reference(seed, halve):
    spec = body_spec_of(qc.compile_query(_query(TStream, seed).node,
                                         out_len=SEG, sparse=True))
    rspec = r_body_spec_of(rqc.compile_query(
        _query(RTStream, seed).node, out_len=SEG, pallas=False, sparse=True))
    if halve:
        spec, rspec = _halved(spec), _halved(rspec)
    got, want = _plan_findings(
        Runner(spec, ExecPolicy(body="sparse"), segs_per_chunk=SPC),
        RRunner(rspec, RPolicy(body="sparse"), segs_per_chunk=SPC))
    assert got == want
    if halve:
        assert ("changeplan-under-dilated", "error") in {
            k[:2] for k in got}


@pytest.mark.parametrize("halve", [False, True])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_pass_plan_union_equals_reference(seed, halve):
    r = union_runner(_union(TStream, seed), SEG,
                     ExecPolicy(body="sparse", dag="union"),
                     segs_per_chunk=SPC)
    rr = r_union_runner(_union(RTStream, seed), SEG,
                        RPolicy(body="sparse", dag="union"),
                        segs_per_chunk=SPC, pallas=False)
    assert len(r.spec.roots) == len(rr.spec.roots) == 3
    if halve:
        r = Runner(_halved(r.spec), r.policy, segs_per_chunk=SPC)
        rr = RRunner(_halved(rr.spec), rr.policy, segs_per_chunk=SPC)
    got, want = _plan_findings(r, rr)
    assert got == want


@pytest.mark.parametrize("horizon,bound", [(2, None), (1, 1000), (1, 4),
                                           (3, 40), (8, 200)])
def test_pass_revision_equals_reference(horizon, bound):
    r = Runner(qc.compile_query(_query(TStream, 0).node, out_len=SEG,
                                sparse=True),
               ExecPolicy(body="sparse"), segs_per_chunk=SPC)
    rr = RRunner(rqc.compile_query(_query(RTStream, 0).node, out_len=SEG,
                                   pallas=False, sparse=True),
                 RPolicy(body="sparse"), segs_per_chunk=SPC)
    t = AuditTarget(runner=r, policy="p", steps=[], chunk_variants=())
    rt = RTarget(runner=rr, policy="p", steps=[], chunk_variants=())
    assert _key(pass_revision(t)) == _key(r_pass_revision(rt)) == []
    r.enable_revision(horizon, revise_bound=bound)
    rr.enable_revision(horizon, revise_bound=bound)
    got = pass_revision(t)
    assert _key(got) == _key(r_pass_revision(rt))
    assert [f.message for f in got] == [f.message
                                        for f in r_pass_revision(rt)]
