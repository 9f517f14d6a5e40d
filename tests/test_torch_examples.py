"""The port's seven TiLT examples (``examples_torch/``) against the
reference's (``examples/``) on the CPU, both at the same reduced sizes
(``torch_examples_common.SIZES``, set through each module's constants and
``main``'s arguments; nothing under ``examples/`` is edited).

Each reference example runs as shipped; the outputs it does not return are
caught where it makes them (its ``Runner``, ``StreamRunner``, session,
``build_service``, ``audit_runner``/``pass_plan``), or read from what it
prints.  Held exactly: the boundary contract, the fusion report, the
union/shared/independent node counts and sharing ratio, the audit verdicts
and findings (codes, messages naming the segments), the derived demand,
and the counts of events, late, revised, corrections, sealed chunks,
revision units and chunks, admitted and shed events; the runner counters,
compaction, bucket picks and outputs of ``metrics_observability``
(integer-valued data).  The outputs of float data are held by
``repro_torch.data.tolerance.compare`` under the app's entry.  The
dashboard's breakout and momentum heads have no such bound against the
reference (see ``repro_torch.data.tolerance``): they are held bit for bit
against the port's own solo ``Runner`` of each query (session ≡ solo).
Timings are never compared.  Every example runs in ``tmp_path``: the
reference's ``metrics_observability`` and ``serving_loop`` write into the
working directory, and the tracked ``metrics.jsonl`` stays as it is.
"""
import re
import runpy
import warnings

import pytest

import repro.core.parallel as rpar
from repro import obs as robs

import torch_examples_common as C


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    before = (C.ROOT / "metrics.jsonl").read_bytes()
    monkeypatch.chdir(tmp_path)
    yield
    assert (C.ROOT / "metrics.jsonl").read_bytes() == before


def _port(name, monkeypatch):
    mod = C.load(name)
    consts, argv = C.SIZES[name]
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    return mod, mod.main(argv + ["--device", "cpu"])


def _ref(name, monkeypatch):
    mod = C.load(name, "examples")
    for k, v in C.SIZES[name][0].items():
        monkeypatch.setattr(mod, k, v)
    return mod


def test_quickstart(monkeypatch):
    _, r = _port("quickstart", monkeypatch)
    g = runpy.run_path(str(C.ROOT / "examples" / "quickstart.py"))
    node = g["uptrend"].node
    want = ({"contract": {k: (b.lookback, b.lookahead)
                          for k, b in g["boundary"].resolve(node).items()},
             "fusion": g["fusion"].fusion_report(node,
                                                 g["fusion"].optimize(node))},
            {"uptrend": ("trend", C.grids([g["out"]]))})
    C.hold("quickstart", C.figures("quickstart", r), want)
    assert r["device"] == "cpu"
    assert r["intervals"] == len(r["events"].events) > 0


def test_stream_analytics(monkeypatch):
    ref = _ref("stream_analytics", monkeypatch)
    outs, runners, app = {}, {}, [None]

    class Spy(ref.StreamRunner):
        def step(self, chunks):
            runners[app[0]] = self
            out = super().step(chunks)
            outs.setdefault(app[0], []).append(out)
            return out

    real = rpar.partition_run

    def spy_partition_run(*a, **kw):
        out = real(*a, **kw)
        outs.setdefault(app[0], []).append(out)
        return out

    monkeypatch.setattr(ref, "StreamRunner", Spy)
    monkeypatch.setattr(rpar, "partition_run", spy_partition_run)
    n_chunks = int(C.SIZES["stream_analytics"][1][0])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for name in ref.A.APPS:
            app[0] = name
            ref.run_app(name, n_chunks)
    want_exact = {name: (("continuous", len(runners[name].state()) - 1)
                         if name in runners else ("partitioned", None))
                  for name in outs}
    want = (want_exact, {name: (name, C.grids(o))
                         for name, o in outs.items()})

    with pytest.warns(DeprecationWarning, match="StreamRunner"):
        _, r = _port("stream_analytics", monkeypatch)
    # the port's own app runs too; the reference has no qrs to hold it to
    assert r.pop("qrs")["mode"] == "continuous"
    got = C.figures("stream_analytics", r)
    held = C.hold("stream_analytics", got, want)
    assert len(held) == 9
    assert {a["mode"] for a in r.values()} == {"continuous", "partitioned"}
    assert {n for n, a in r.items() if a["mode"] == "partitioned"} == {
        "znorm", "impute", "resample"}


def test_multikey_analytics(monkeypatch):
    ref = _ref("multikey_analytics", monkeypatch)
    runs, sessions = [], []

    class SpyRunner(ref.Runner):
        def run(self, *a, **kw):
            out = super().run(*a, **kw)
            runs.append(out)
            return out

    class SpySession(ref.MultiQuerySession):
        def run(self, *a, **kw):
            sessions.append(self)
            self.last = super().run(*a, **kw)
            return self.last

    monkeypatch.setattr(ref, "Runner", SpyRunner)
    monkeypatch.setattr(ref, "MultiQuerySession", SpySession)
    n_users = int(C.SIZES["multikey_analytics"][1][0])
    ref.fraud_demo(n_users)
    ref.dashboard_demo(n_users)
    sess = sessions[-1]
    rep = sess.sharing_report()
    want = ({"union_nodes": rep.union_nodes,
             "shared_nodes": rep.shared_nodes,
             "independent_nodes": rep.independent_nodes,
             "sharing_ratio": rep.sharing_ratio},
            {"fraud": ("fraud", C.grids([runs[-1]])),
             **{f"dashboard/{q}": ("dashboard", C.trend_head(q, g))
                for q, g in sess.last.items() if not C.is_vol_head(q)}})

    mod, r = _port("multikey_analytics", monkeypatch)
    held = C.hold("multikey_analytics", C.figures("multikey_analytics", r),
                  want)
    assert len(held) == 1 + 4
    consts = {"N_TICKS": mod.N_TICKS, "N_PARTS": mod.N_PARTS}
    assert C.hold_vol_heads_solo(r, consts, n_users, "cpu") == 4
    assert r["fraud"]["caught"] > 0


_LATE = re.compile(r"events=(\d+)\s+sealed_chunks=(\d+)\s+late=(\d+)\s+"
                   r"revised=(\d+)\s+corrections=(\d+)")
_REVISION = re.compile(r"revision work: (\d+) dirty segments recomputed "
                       r"across (\d+) chunk revisions")


def test_late_data(monkeypatch, capsys):
    ref = _ref("late_data", monkeypatch)
    inorder = []

    class SpyRunner(ref.Runner):
        def run(self, *a, **kw):
            out = super().run(*a, **kw)
            inorder.append(out)
            return out

    monkeypatch.setattr(ref, "Runner", SpyRunner)
    ref.main()
    text = capsys.readouterr().out
    assert "disorder-insensitivity OK" in text
    ev, sealed, late, revised, corr = map(int, _LATE.search(text).groups())
    units, chunks = map(int, _REVISION.search(text).groups())
    want = ({"events": ev, "sealed_chunks": sealed, "late": late,
             "revised": revised, "corrections": corr,
             "revision_units": units, "revision_chunks": chunks},
            {"fraud": ("fraud", C.grids(inorder))})

    _, r = _port("late_data", monkeypatch)
    assert "disorder-insensitivity OK" in capsys.readouterr().out
    C.hold("late_data", C.figures("late_data", r), want)
    assert r["late"] > 0 and r["corrections"] > 0 and r["flagged"] > 0


def test_metrics_observability(monkeypatch, tmp_path):
    ref = _ref("metrics_observability", monkeypatch)
    made, outs = [], []

    class SpyRunner(ref.Runner):
        def step(self, chunk):
            made.append(self)
            out = super().step(chunk)
            outs.append(out)
            return out

    monkeypatch.setattr(ref, "Runner", SpyRunner)
    n_chunks = int(C.SIZES["metrics_observability"][1][0])
    ref.main(n_chunks)
    snap = made[-1].metrics.snapshot()
    c, g = snap["counters"], snap["gauges"]
    picks = snap["vectors"]["runner.bucket_picks"]
    want_exact = {k: c[k]["value"] for k in ("runner.chunks", "runner.units",
                                             "runner.dirty_units")}
    want_exact.update({
        "runner.compact": g["runner.compact"]["value"],
        "bucket_picks": {lab: n for lab, n in zip(picks["labels"],
                                                  picks["values"]) if n},
        "retraces": snap["compiles"]["retraces"]})
    want = (want_exact, {"outputs": (None, C.grids(outs))})

    _, r = _port("metrics_observability", monkeypatch)
    C.hold("metrics_observability", C.figures("metrics_observability", r),
           want)
    assert r["compiles"]["retraces"] == {}
    assert robs.validate_snapshot(r["snapshot"]) == []
    assert (tmp_path / "out" / "metrics.jsonl").exists()
    assert (tmp_path / "metrics.jsonl").exists()    # the reference's


def test_plan_audit(monkeypatch, tmp_path):
    ref = _ref("plan_audit", monkeypatch)
    seen = {}

    def spy(name, fn):
        def call(*a, **kw):
            seen[name] = fn(*a, **kw)
            return seen[name]
        monkeypatch.setattr(ref, name, call)

    for name in ("audit_runner", "pass_plan", "derive_bounds"):
        spy(name, getattr(ref, name))
    ref.main()
    ref_path = tmp_path / "out" / "example_audit.jsonl"
    ref_lines = ref_path.read_text().splitlines()
    ref_path.unlink()
    exe = ref.qc.compile_query(ref.make_query().node, out_len=ref.SEG,
                               pallas=False, sparse=True)
    want = ({"verdict": ref.verdict(seen["audit_runner"]),
             "findings": C.findings_key(seen["audit_runner"]),
             "demand": tuple(seen["derive_bounds"]["in"]),
             "contract": tuple(exe.input_specs["in"].contract_t()),
             "bad_verdict": ref.verdict(seen["pass_plan"]),
             "bad_findings": C.findings_key(seen["pass_plan"])}, {})

    _, r = _port("plan_audit", monkeypatch)
    C.hold("plan_audit", C.figures("plan_audit", r), want)
    assert r["verdict"] == "clean" and r["bad_verdict"] == "error"
    assert any("segments [" in f.message for f in r["bad_findings"])
    assert len(ref_path.read_text().splitlines()) == len(ref_lines)


def test_serving_loop(monkeypatch):
    ref = _ref("serving_loop", monkeypatch)
    real = ref.build_service
    runs = []

    def spy_build(*a, **kw):
        svc = real(*a, **kw)
        rec = runs[-1]
        rec["svcs"].append(svc)
        serve, pump, finish = svc.serve, svc.pump, svc.finish

        def rec_serve(*a2, **kw2):
            for o in serve(*a2, **kw2):
                rec["outs"].append(o)
                yield o

        def rec_sealed(fn):
            def call(*a2, **kw2):
                sealed, corr = fn(*a2, **kw2)
                rec["sealed"] += [s.outputs for s in sealed]
                return sealed, corr
            return call

        svc.serve = rec_serve
        svc.pump, svc.finish = rec_sealed(pump), rec_sealed(finish)
        return svc

    monkeypatch.setattr(ref, "build_service", spy_build)
    wants = []
    for _ in range(2):
        runs.append({"svcs": [], "outs": [], "sealed": []})
        ref.main()
        rec = runs[-1]
        svc, svc2 = rec["svcs"]
        cnt = svc2.runner.metrics.snapshot()["counters"]
        wants.append((
            {"plan_source": svc.plan_source,
             "event_plan_source": svc2.plan_source,
             "admitted": int(cnt["serve.admitted"]["value"]),
             "sealed_chunks": len(rec["sealed"]),
             "shed": int(cnt["serve.shed_events"]["value"]),
             "chunks": len(rec["outs"])},
            {"chunks": ("fraud", C.grids(rec["outs"])),
             "sealed": ("fraud", C.grids(rec["sealed"]))}))
    assert [w[0]["plan_source"] for w in wants] == ["cold", "warm"]

    for want in wants:
        _, r = _port("serving_loop", monkeypatch)
        C.hold("serving_loop", C.figures("serving_loop", r), want)
        assert r["flagged"] == int(sum(int(o.valid.sum())
                                       for o in r["outs"]))


def test_the_examples_reach_the_kernels(monkeypatch):
    """Which kernel wrappers each example calls (on the CPU, their plain
    versions; on the card, the kernels): ``sliding_assoc`` in every one,
    ``seg_dirty`` in the sparse ones, ``prefix_scan`` in none (no example
    sums a window under 8 ticks or asks for ``sum_algo="soe"``)."""
    from repro_torch.kernels import sparse_compact, window_reduce
    calls, name = {}, [None]

    def spy(mod, fn):
        real = getattr(mod, fn)

        def call(*a, **kw):
            calls.setdefault(name[0], set()).add(fn)
            return real(*a, **kw)
        monkeypatch.setattr(mod, fn, call)

    for fn in ("prefix_scan", "sliding_assoc"):
        spy(window_reduce, fn)
    spy(sparse_compact, "seg_dirty")
    for n in C.TILT:
        name[0] = n
        _port(n, monkeypatch)
    sparse = {"late_data", "metrics_observability", "plan_audit",
              "serving_loop"}
    assert calls == {n: {"sliding_assoc"} | ({"seg_dirty"} if n in sparse
                                             else set())
                     for n in C.TILT}
