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
from repro_torch.data import apps

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


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
    r"^\s*(import\s+(jax|jaxlib|repro)\b|from\s+(jax|jaxlib|repro)\b"
    r"|from\s+\.\.+\s*import\s+repro\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_sources_import_neither_jax_nor_the_reference(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    _no_cuda(monkeypatch)
    es = stream.EventStream([stream.Event(0, 3, 1.0)])
    data = apps.make_app("trend").make_input(16, 0)
    for call in (lambda **kw: stream.events_to_grid(es, 0, 4, 1, **kw),
                 lambda **kw: apps.make_grids(data, **kw),
                 lambda **kw: convert.to_grid(np.zeros(4, np.float32),
                                              np.ones(4, bool), 0, 1, **kw)):
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
