"""Rules the port keeps: it never loads jax or the reference package, and
its entry points run on CUDA unless the caller asks for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import convert
from repro_torch.core import stream
from repro_torch.data import apps, streams
from repro_torch.engine import keyed_grid
from repro_torch.ingest import IngestRunner, ReorderBuffer
from repro_torch.launch.mesh import make_local_mesh

import torch_examples_common as C

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_the_rules_cover_the_serving_package():
    mods = set(_modules())
    assert {"repro_torch.serve", "repro_torch.serve.aot",
            "repro_torch.serve.loop", "repro_torch.serve.ring",
            "repro_torch.serve.__main__",
            "repro_torch.engine.capture"} <= mods
    paths = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"serve/aot.py", "serve/loop.py", "serve/ring.py",
            "serve/__main__.py"} <= paths


def test_the_rules_cover_the_analysis_package():
    """The auditor is among the modules imported and scanned below."""
    assert {"repro_torch.analysis", "repro_torch.analysis.audit",
            "repro_torch.analysis.findings", "repro_torch.analysis.graphs",
            "repro_torch.analysis.passes", "repro_torch.analysis.planverify",
            "repro_torch.analysis.__main__"} <= set(_modules())


def test_the_rules_cover_the_launch_package():
    """The mesh module is among the modules imported and scanned below."""
    assert {"repro_torch.launch", "repro_torch.launch.mesh"} <= set(
        _modules())
    paths = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"launch/__init__.py", "launch/mesh.py"} <= paths


def test_the_rules_cover_the_lm_packages():
    """The LM stack (configs, models, serve steps, the serving loop) is
    among the modules imported and scanned below."""
    assert {"repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen3_1_7b",
            "repro_torch.configs.whisper_large_v3",
            "repro_torch.models", "repro_torch.models.layers",
            "repro_torch.models.recurrent", "repro_torch.models.transformer",
            "repro_torch.models.encdec", "repro_torch.models.model",
            "repro_torch.train", "repro_torch.train.train_step",
            "repro_torch.launch.serve"} <= set(_modules())
    paths = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"configs/base.py", "models/layers.py", "train/train_step.py",
            "launch/serve.py"} <= paths
    from repro_torch.configs import registry
    assert len(registry()) == 10


def test_the_rules_cover_the_training_modules():
    """Training (the optimizer, the train step, checkpoints, the data
    pipelines and the training loop) is among the modules imported and
    scanned below."""
    assert {"repro_torch.train.optimizer", "repro_torch.train.checkpoint",
            "repro_torch.train.train_step", "repro_torch.data.pipeline",
            "repro_torch.launch.train"} <= set(_modules())
    paths = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"train/optimizer.py", "train/checkpoint.py",
            "train/train_step.py", "data/pipeline.py",
            "launch/train.py"} <= paths


def test_the_rules_cover_the_sharding_and_roofline_modules():
    """Sharding (the hints, the rules), the dry-run and the roofline are
    among the modules imported and scanned below."""
    assert {"repro_torch.models.shardctx", "repro_torch.launch.sharding",
            "repro_torch.launch.dryrun", "repro_torch.roofline",
            "repro_torch.roofline.analysis", "repro_torch.roofline.recompute",
            "repro_torch.roofline.report"} <= set(_modules())
    paths = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    assert {"models/shardctx.py", "launch/sharding.py", "launch/dryrun.py",
            "roofline/analysis.py", "roofline/recompute.py",
            "roofline/report.py"} <= paths


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: os.environ[k] for k in ("PATH", "HOME", "JAX_PLATFORMS",
                                      "TMPDIR") if k in os.environ}
    env["PYTHONPATH"] = str(ROOT / "src")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro|examples)\b"
    r"|from\s+(jax|jaxlib|repro|examples)\b"
    r"|from\s+\.\.+\s*import\s+repro\b)", re.M)
EXAMPLES = ROOT / "examples_torch"


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + [p.relative_to(ROOT).as_posix() for p in EXAMPLES.glob("*.py")]
    + ["chip_smoke.py", "tests/torch_examples_common.py"]))
def test_sources_import_neither_jax_nor_the_reference(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path
    if path.startswith("examples_torch/"):
        # nor the reference's example, by path
        assert "examples/" not in text.replace("examples_torch/", ""), path


def test_the_rules_cover_every_example():
    """Each of the reference's examples has its port, under its name."""
    names = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == names
    assert sorted(C.TILT + C.LM) == names


def _example_argv(name, mod, monkeypatch, tmp_path):
    """A cheap run of one example: the examples tests' sizes, one train
    step into ``tmp_path``."""
    if name == "train_lm":
        from repro_torch.configs import base
        base.registry()                 # the example registers its config
        monkeypatch.setattr(base, "_REGISTRY", dict(base._REGISTRY))
        return ["--steps", "1", "--ckpt-dir", str(tmp_path / "ckpt")]
    if name == "serve_lm":
        return []
    consts, argv = C.SIZES[name]
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    return argv


@pytest.mark.parametrize("name", C.TILT + C.LM)
def test_examples_raise_without_cuda_unless_asked_for_cpu(name, monkeypatch,
                                                          tmp_path):
    monkeypatch.chdir(tmp_path)
    mod = C.load(name)
    argv = _example_argv(name, mod, monkeypatch, tmp_path)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
    assert not (tmp_path / "out").exists()
    res = mod.main(argv + ["--device", "cpu"])
    assert isinstance(res, dict) and res


def _ingest_runner(**kw):
    """An IngestRunner over a sparse runner: its reorder buffers build the
    sealed grids, so it takes the device."""
    from repro_torch.core import compile as qc
    from repro_torch.engine import ExecPolicy, Runner
    exe = qc.compile_query(streams.fraud_query(16).node, out_len=32,
                           sparse=True)
    return IngestRunner(Runner(exe, ExecPolicy(body="sparse")), lateness=4,
                        **kw)


def _service(**kw):
    """A served runner: it prepares its steps on the device it is given."""
    from repro_torch.serve import build_service
    return build_service(streams.fraud_query(16), out_len=32,
                         segs_per_chunk=2, **kw)


def _analysis_cli(device=None):
    """``python -m repro_torch.analysis`` over one lattice point: it runs
    on CUDA unless ``--device cpu`` is given."""
    import tempfile
    from repro_torch.analysis.__main__ import main
    with tempfile.TemporaryDirectory() as d:
        return main(["--policy", "dense×single×local×solo", "--passes",
                     "plan", "--out", f"{d}/a.jsonl"]
                    + (["--device", device] if device else []))


def _lm_serve_cli(device=None):
    """``python -m repro_torch.launch.serve``: on CUDA unless ``--device
    cpu`` is given."""
    from repro_torch.launch import serve
    return serve.main(["--smoke", "--batch", "1", "--prompt-len", "4",
                       "--gen", "2", "--requests", "1"]
                      + (["--device", device] if device else []))


def _lm_model(**kw):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return build_model(get_config("qwen3-1.7b", smoke=True), **kw)


def _lm_params(**kw):
    """Weights in the reference's tree (here the port's own, f32, as
    numpy; unscanned, so every layer is a ``rest{i}``) carried over."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True),
                              dtype="float32", param_dtype="float32",
                              scan_layers=False)
    tree = build_model(cfg, device="cpu").init().tree()
    as_np = lambda d: {k: (v.numpy() if torch.is_tensor(v) else as_np(v))
                       for k, v in d.items()}
    ref = as_np({k: v for k, v in tree.items() if k != "blocks"})
    ref.update({f"rest{i}": as_np(b) for i, b in enumerate(tree["blocks"])})
    return convert.lm_params_from_numpy(cfg, ref, **kw)


def _lm_train_cli(device=None):
    """``python -m repro_torch.launch.train``: on CUDA unless ``--device
    cpu`` is given."""
    from repro_torch.launch import train
    return train.main(["--smoke", "--steps", "1", "--batch", "1", "--seq",
                       "4"] + (["--device", device] if device else []))


def _token_pipeline(**kw):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    return TokenPipeline(get_config("qwen3-1.7b", smoke=True), 1, 4,
                         **kw).next()


def _feature_pipeline(**kw):
    from repro_torch.core import compile as qc
    from repro_torch.data.pipeline import StreamFeaturePipeline
    exe = qc.compile_query(streams.fraud_query(16).node, out_len=32)
    return StreamFeaturePipeline(exe, **kw)


def _checkpoint_restore(**kw):
    import tempfile
    from repro_torch.train import checkpoint
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, {"x": torch.zeros(2)})
        return checkpoint.restore(d, **kw)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    _no_cuda(monkeypatch)
    es = stream.EventStream([stream.Event(0, 3, 1.0)])
    data = apps.make_app("trend").make_input(16, 0)
    for call in (lambda **kw: stream.events_to_grid(es, 0, 4, 1, **kw),
                 lambda **kw: apps.make_grids(data, **kw),
                 lambda **kw: convert.to_grid(np.zeros(4, np.float32),
                                              np.ones(4, bool), 0, 1, **kw),
                 lambda **kw: streams.burst_grids(64, 0.1, 0, **kw),
                 lambda **kw: streams.keyed_activity_grids(4, 16, 0.5, 0,
                                                           **kw),
                 lambda **kw: keyed_grid(np.zeros((2, 8), np.float32),
                                         np.ones((2, 8), bool), **kw),
                 lambda **kw: ReorderBuffer(prec=1, chunk_ticks=8, **kw),
                 lambda **kw: _ingest_runner(**kw),
                 lambda **kw: _service(**kw),
                 lambda **kw: convert.state_from_numpy(
                     {"in": (np.zeros(4), np.ones(4, bool)), "__t": 0},
                     **kw),
                 lambda **kw: make_local_mesh(**kw),
                 lambda **kw: _analysis_cli(**kw),
                 lambda **kw: _lm_model(**kw),
                 lambda **kw: _lm_params(**kw),
                 lambda **kw: _lm_serve_cli(**kw),
                 lambda **kw: _lm_train_cli(**kw),
                 lambda **kw: _token_pipeline(**kw),
                 lambda **kw: _feature_pipeline(**kw),
                 lambda **kw: _checkpoint_restore(**kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        assert call(device="cpu") is not None


def test_executors_follow_their_inputs_device(monkeypatch):
    """compile_query/partition_run/batch_run take no device: they run where
    the input tensors are, so CPU inputs run on the CPU even without CUDA."""
    from repro_torch.core import compile as qc
    from repro_torch.core import parallel as par
    _no_cuda(monkeypatch)
    app = apps.make_app("trend")
    grids = apps.make_grids(app.make_input(256, 0), device="cpu")
    exe = qc.compile_query(app.query.node, out_len=128)
    out = par.partition_run(exe, grids, 0, 2)
    assert out.valid.device.type == "cpu" and out.valid.shape == (256,)
    keyed = apps.make_keyed_app("trend")
    kg = apps.make_grids(keyed.make_keyed_input(3, 128, 0), device="cpu")
    kout = par.batch_run(qc.compile_query(keyed.query.node, out_len=128), kg)
    assert kout.valid.device.type == "cpu" and kout.valid.shape == (3, 128)


def test_runner_and_sparse_run_follow_their_inputs_device(monkeypatch):
    """The runner and the one-shot sparse path take no device either: CPU
    chunks run on the CPU without CUDA, the wrappers' kernels never
    launch."""
    from repro_torch.core import compile as qc
    from repro_torch.core import sparse
    from repro_torch.engine import ExecPolicy, Runner
    from repro_torch.kernels import sparse_compact
    _no_cuda(monkeypatch)
    q = streams.fraud_query(16).node
    grids = streams.burst_grids(256, 0.1, 0, device="cpu")
    n0 = sparse_compact.launches["seg_dirty"]
    r = Runner(qc.compile_query(q, out_len=32, sparse=True),
               ExecPolicy(body="sparse"), segs_per_chunk=2)
    out = r.run(grids, 4)
    assert out.valid.device.type == "cpu" and out.valid.shape == (256,)
    s = sparse.sparse_run(qc.compile_query(q, out_len=32, sparse=True),
                          grids, 0, 8)
    assert s.valid.device.type == "cpu"
    assert sparse_compact.launches["seg_dirty"] == n0


def test_ingest_and_sessions_follow_their_inputs_device(monkeypatch):
    """Sealed chunks are born on the device the ingest runner was given; a
    union session and a revision run where their chunks are."""
    from repro_torch.core.stream import Event
    from repro_torch.multiquery import MultiQuerySession
    from repro_torch.kernels import sparse_compact
    _no_cuda(monkeypatch)
    n0 = sparse_compact.launches["seg_dirty"]
    ing = _ingest_runner(device="cpu")
    for t in range(0, 96, 4):
        ing.push("in", Event(t, t + 4, float(t % 7)))
    ing.push("in", Event(2, 3, 9.0))             # late: a revision
    sealed, corr = ing.flush()
    assert sealed and all(s.outputs.valid.device.type == "cpu"
                          for s in sealed)
    sess = MultiQuerySession(32, sparse=True)
    for name, q in apps.dashboard_queries(4, short=4, long=8).items():
        sess.attach(name, q)
    out = sess.run(streams.burst_grids(64, 0.1, 0, device="cpu"), 2)
    assert all(g.valid.device.type == "cpu" for g in out.values())
    assert sparse_compact.launches["seg_dirty"] == n0
