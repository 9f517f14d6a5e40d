"""The port's static auditor audits itself, as ``tests/test_analysis.py``
holds the reference's: the known-bad corpus must fire, the shipped runner
must stay silent at the same policy point.

The corpus lives here (``tests/analysis_corpus/`` is the reference's).
Each fixture seeds one bug class as it exists in torch:

* ``host_read`` — the result assembly reads a value on the host
  (``.item()``): C1's class, a synchronizing call per chunk → transfer
  pass, ``host-sync``.
* ``copy_out`` — the result assembly copies its outputs outside the step:
  C3's class → transfer pass, ``eager-op-outside-staged-step``.  The
  reference's eager ``x[0]`` strip (its eager-indexing class) has no
  counterpart: in torch ``x[0]`` is a view, which moves no data and reads
  nothing.
* ``dead_prev`` — the workspace also carries 1-tick ``prev`` snapshots for
  halo-carrying inputs, which the step writes and never reads → donation
  pass, ``donated-leaf-dead``.
* ``body_gather`` — a mesh runner all-gathers inside a compacted body, on
  the 1-rank mesh → collective pass, ``collective-under-divergence``.
* ``under_keyed`` — a step-cache key that drops ``n_segs`` → recompile
  pass, ``staging-key-under-captures``.
* ``under_dilated`` — a ChangePlan whose lookback is halved (the
  reference's fixture) → plan verifier.

The file imports neither jax nor the reference, so the card's tests
(``tests/test_torch_cuda.py``) and ``chip_smoke.py`` run the same corpus
there; the port-against-reference checks are in
``tests/test_torch_analysis_ref.py``.  Everything here runs on the CPU,
the mesh fixtures on a 1-rank gloo mesh.
"""
import dataclasses
import json

import pytest
import torch
from torch.utils._pytree import tree_map

from repro_torch.analysis import (Finding, SCHEMA, AuditTarget,
                                  audit_runner, export_jsonl, make_target,
                                  read_jsonl, validate_finding, verdict)
from repro_torch.analysis.passes import (pass_collectives, pass_donation,
                                         pass_recompile, pass_transfers)
from repro_torch.analysis.planverify import derive_bounds, pass_plan
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.engine import ExecPolicy, Runner, mesh_placement
from repro_torch.engine.runner import body_spec_of

SEG = 16
SPC = 4
N_KEYS = 4
SPARSE = ExecPolicy(body="sparse")

# the only warning the shipped runner gives at a corpus point: a sparse
# mesh step replays a second graph (the hold or gather after the switched
# step: ROADMAP C10), which the reference's one staged step does not
MESH_SPARSE_WARNINGS = {"staged-dispatch-count"}


def trend_query(keyed: bool = False):
    s = TStream.source("in", prec=1, keyed=keyed)
    return (s.window(8).mean()
            .join(s.window(16).mean(), lambda a, b: a - b)
            .where(lambda d: d > 0))


def trend_exe(keyed: bool = False):
    return qc.compile_query(trend_query(keyed).node, out_len=SEG,
                            sparse=True)


class HostReadRunner(Runner):
    """Shipped runner, except the result assembly reads a value on the
    host every chunk."""

    def _postprocess(self, outs):
        outs = super()._postprocess(outs)
        for _v, m in outs.values():
            m.any().item()
        return outs


class CopyOutRunner(Runner):
    """Shipped runner, except the result assembly copies the outputs."""

    def _postprocess(self, outs):
        return {o: (tree_map(torch.clone, v), m.clone())
                for o, (v, m) in super()._postprocess(outs).items()}


def _with_prevs(work, chunk_in):
    for name in work.names:
        if name not in work.prev:
            cv, _ = chunk_in[name]
            work.prev[name] = (
                tree_map(lambda x: torch.zeros(x.shape[:-1] + (1,),
                                               dtype=x.dtype,
                                               device=work.dev), cv),
                torch.zeros((work.bufs[name][1].shape[0], 1),
                            dtype=torch.bool, device=work.dev))
    return work


class DeadPrevRunner(Runner):
    """Shipped runner, except the workspace snapshots *every* input, not
    just the halo-free ones the step reads."""

    def _audit_state(self, chunk_in, dev, *, revision=False):
        work = super()._audit_state(chunk_in, dev, revision=revision)
        return work if revision else _with_prevs(work, chunk_in)

    def _live(self, chunk_in, dev):
        return _with_prevs(super()._live(chunk_in, dev), chunk_in)


class BodyGatherRunner(Runner):
    """Shipped mesh runner, except each compacted body all-gathers its
    results: ranks that pick different buckets would hang in it."""

    def _sparse_body(self, cap, dev):
        body, comm = super()._sparse_body(cap, dev), self._comm

        def gathered(work):
            body(work)
            for f in work.full_flats.values():
                comm.gather_flat(f)
        return gathered


class UnderKeyedRunner(Runner):
    """Shipped runner, except the step-cache key forgets the chunk
    geometry (``n_segs`` kept as ``None``, so labels keep their places)."""

    def _cache_key(self, kind, dev, *extra):
        d = self.staging_key_dofs(dev)
        return (kind, d["K"], None, d["device"], d["mesh"], d["axis"]) + extra


def under_dilated_runner():
    """A runner whose ChangePlan's lookback dilation is half what the IR
    demands (the plan verifier never records steps)."""
    spec = body_spec_of(trend_exe())
    cp = spec.change_plan
    halved = dataclasses.replace(cp, specs={
        name: dataclasses.replace(sp, lookback=sp.lookback // 2)
        for name, sp in cp.specs.items()})
    bad = dataclasses.replace(spec, change_plan=halved, step_cache={})
    return Runner(bad, SPARSE, segs_per_chunk=SPC)


def mesh_policy(mesh):
    return ExecPolicy(body="sparse", keys="vmapped",
                      placement=mesh_placement(mesh))


# name -> (pass, code, the fixture's runner built over ``mesh``, a 1-rank
# mesh on the audit's device); ``shipped_runner`` gives the same point's
# shipped runner
CORPUS = {
    "host_read": (pass_transfers, "host-sync", lambda mesh: HostReadRunner(
        trend_exe(), SPARSE, segs_per_chunk=SPC)),
    "copy_out": (pass_transfers, "eager-op-outside-staged-step",
                 lambda mesh: CopyOutRunner(trend_exe(), SPARSE,
                                            segs_per_chunk=SPC)),
    "dead_prev": (pass_donation, "donated-leaf-dead",
                  lambda mesh: DeadPrevRunner(trend_exe(), SPARSE,
                                              segs_per_chunk=SPC)),
    "body_gather": (pass_collectives, "collective-under-divergence",
                    lambda mesh: BodyGatherRunner(
                        trend_exe(True), mesh_policy(mesh), n_keys=N_KEYS,
                        segs_per_chunk=SPC)),
    "under_keyed": (pass_recompile, "staging-key-under-captures",
                    lambda mesh: UnderKeyedRunner(trend_exe(), SPARSE,
                                                  segs_per_chunk=SPC)),
    "under_dilated": (pass_plan, "changeplan-under-dilated",
                      lambda mesh: under_dilated_runner()),
}


def shipped_runner(name: str, mesh):
    """The shipped runner at a corpus fixture's policy point."""
    if name == "body_gather":
        return Runner(trend_exe(True), mesh_policy(mesh), n_keys=N_KEYS,
                      segs_per_chunk=SPC)
    return Runner(trend_exe(), SPARSE, segs_per_chunk=SPC)


def corpus_findings(name: str, device, mesh):
    """The fixture's pass over the fixture, on ``device``."""
    fn, _code, build = CORPUS[name]
    r = build(mesh)
    return fn(make_target(r, policy=f"corpus:{name}", device=device))


def shipped_noise(name: str, device, mesh):
    """Warnings and errors of a full audit of the shipped runner at the
    fixture's point, less the documented mesh-sparse warning."""
    r = shipped_runner(name, mesh)
    allowed = MESH_SPARSE_WARNINGS if r.policy.mesh is not None else set()
    return [f for f in audit_runner(r, policy=f"main:{name}", device=device)
            if f.severity == "error"
            or (f.severity == "warning" and f.code not in allowed)]


@pytest.fixture(scope="module")
def gloo_mesh():
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(device="cpu")


def _codes(findings):
    return {f.code for f in findings}


# -- the corpus fires (zero false negatives) --------------------------------

def test_corpus_host_read_and_copy_out_fire_transfer_pass(gloo_mesh):
    read = corpus_findings("host_read", "cpu", gloo_mesh)
    hits = [f for f in read if f.code == "host-sync"]
    assert hits and all(f.severity == "error" for f in hits)
    assert all(f.provenance.endswith("aten._local_scalar_dense")
               and "step" not in f.provenance for f in hits)
    copy = corpus_findings("copy_out", "cpu", gloo_mesh)
    eager = [f for f in copy if f.code == "eager-op-outside-staged-step"]
    assert eager and all(f.severity == "error" for f in eager)
    assert any("C3" in f.message for f in eager)
    assert "host-sync" not in _codes(copy)


def test_corpus_dead_prev_fires_donation_pass(gloo_mesh):
    findings = corpus_findings("dead_prev", "cpu", gloo_mesh)
    dead = [f for f in findings if f.code == "donated-leaf-dead"]
    assert dead and all(f.severity == "error" for f in dead)
    # the dead buffers are exactly the halo-carrying input's snapshots
    assert {f.provenance for f in dead} == {"prev['in'][0]",
                                            "prev['in'][1]"}


def test_corpus_body_gather_fires_collective_pass(gloo_mesh):
    findings = corpus_findings("body_gather", "cpu", gloo_mesh)
    hits = [f for f in findings if f.code == "collective-under-divergence"]
    assert hits and all(f.severity == "error" for f in hits)
    assert all("/body[" in f.provenance and "c10d." in f.provenance
               for f in hits)


def test_corpus_under_keyed_fires_recompile_pass(gloo_mesh):
    findings = corpus_findings("under_keyed", "cpu", gloo_mesh)
    hits = [f for f in findings if f.code == "staging-key-under-captures"]
    assert hits and all(f.severity == "error" for f in hits)
    assert any(f.target == "segs_per_chunk" for f in hits)


def test_corpus_under_dilated_fires_plan_verifier():
    r = under_dilated_runner()
    # the plan verifier never records steps
    findings = pass_plan(AuditTarget(runner=r, policy="corpus:under_dilated",
                                     steps=[], chunk_variants=()))
    codes = _codes(findings)
    assert "changeplan-under-dilated" in codes
    # and the affine lowering at the runner's geometry really misses
    # segments a dilated scan window would have caught
    assert "dilation-misses-segments" in codes
    assert all(f.severity == "error" for f in findings
               if f.code in ("changeplan-under-dilated",
                             "dilation-misses-segments"))


# -- the shipped runner stays silent (zero findings on main) ----------------

def test_shipped_runner_audits_clean_at_corpus_point():
    r = Runner(trend_exe(), SPARSE, segs_per_chunk=SPC)
    findings = audit_runner(r, policy="main:sparse-single-local-solo",
                            device="cpu")
    assert [f for f in findings if f.severity in ("warning", "error")] == []


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_shipped_runner_quiet_at_each_fixture_point(gloo_mesh, name):
    assert shipped_noise(name, "cpu", gloo_mesh) == []


# -- the verifier's independent demand derivation ---------------------------

def test_derived_demand_matches_planned_halos_when_tight():
    """At prec=1 the boundary-resolution halos are exact, so the
    verifier's independently re-derived demand must agree bit-for-bit."""
    exe = trend_exe()
    req = derive_bounds((trend_query(False).node,))
    s = exe.input_specs["in"]
    assert req["in"] == (s.left_halo * s.prec, s.right_halo * s.prec)


# -- findings schema + exporters --------------------------------------------

def test_finding_json_roundtrip_and_validation(tmp_path):
    f = Finding("warning", "plan", "halo-overwide", "msg",
                policy="dense×single×local×solo", target="in",
                provenance="left_halo=16")
    d = f.to_json()
    assert d["schema"] == SCHEMA == "repro.analysis/v1"
    assert d["pass"] == "plan"
    assert validate_finding(d) == []
    assert Finding.from_json(d) == f

    path = export_jsonl([f, f], tmp_path / "a.jsonl")
    back = read_jsonl(path)
    assert back == [f, f]
    with open(path) as fh:
        lines = [json.loads(line) for line in fh]
    assert all(line["schema"] == SCHEMA for line in lines)


def test_validate_finding_flags_problems():
    assert validate_finding({"schema": "nope"})  # wrong schema + missing
    bad = Finding("error", "x", "c", "m").to_json()
    bad["severity"] = "fatal"
    assert any("severity" in p for p in validate_finding(bad))


def test_verdict_ladder():
    assert verdict([]) == "clean"
    assert verdict([Finding("info", "p", "c", "m")]) == "info"
    assert verdict([Finding("info", "p", "c", "m"),
                    Finding("error", "p", "c", "m")]) == "error"


# -- CLI --------------------------------------------------------------------

def test_cli_clean_point_exits_zero(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "analysis.jsonl"
    rc = main(["--policy", "sparse×single×local×solo",
               "--passes", "plan,transfer", "--out", str(out),
               "--device", "cpu"])
    assert rc == 0
    assert out.exists() and read_jsonl(out) == []


def test_cli_fail_on_threshold(tmp_path, monkeypatch):
    import repro_torch.analysis.__main__ as m
    finding = Finding("warning", "plan", "c", "msg")
    monkeypatch.setattr(m, "audit_lattice",
                        lambda policies, passes=None, device=None:
                        [finding])
    out = str(tmp_path / "f.jsonl")
    cpu = ["--device", "cpu", "--out", out]
    assert m.main(cpu) == 0                                 # fail-on error
    assert m.main(["--fail-on", "warning"] + cpu) == 1
    assert m.main(["--fail-on", "never"] + cpu) == 0
    assert m.main(["--json", "--fail-on", "info"] + cpu) == 1
    assert read_jsonl(out) == [finding]


def test_cli_rejects_unknown_pass_and_policy(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = str(tmp_path / "x.jsonl")
    with pytest.raises(SystemExit):
        main(["--passes", "bogus", "--out", out, "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--policy", "no-such-point", "--out", out, "--device", "cpu"])
