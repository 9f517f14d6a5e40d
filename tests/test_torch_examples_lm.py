"""The port's LM examples (``examples_torch/serve_lm.py`` and
``train_lm.py``) on the CPU, beside the reference's.

The port draws its weights from its own generator, so its losses and
tokens are not the reference's; ``test_torch_lm_*`` and
``test_torch_train_*`` hold the models against the reference with the
weights carried across (``convert.lm_params_to_numpy``).  Here:
``train_lm`` registers the reference's demo config (the same parameter
count) and trains it to finite losses with checkpoints; ``serve_lm``
serves as many requests and tokens as the reference's example.
"""
import math
import re
import sys

import pytest

from repro_torch.configs import base as cb

import torch_examples_common as C


@pytest.fixture
def registry(monkeypatch):
    """The port's config registry, restored after the test (the example
    registers its demo config in it)."""
    cb.registry()
    monkeypatch.setattr(cb, "_REGISTRY", dict(cb._REGISTRY))
    return cb._REGISTRY


@pytest.mark.parametrize("full", [False, True])
def test_train_lm_configs_match_the_reference(full):
    ref = C.load("train_lm", "examples").config(full)
    port = C.load("train_lm").config(full)
    assert port.name == ref.name
    assert port.n_params() == ref.n_params()


_STEP = re.compile(r"\[train\] step (\d+) loss (\S+) gnorm (\S+)")


def test_train_lm_registers_and_trains(registry, tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    r = C.load("train_lm").main(["--steps", "3", "--ckpt-dir", str(ckpt),
                                 "--device", "cpu"])
    ref_n = C.load("train_lm", "examples").config(False).n_params()
    assert r["arch"] == "demo-10m" and r["n_params"] == ref_n
    assert registry["demo-10m"][0].n_params() == ref_n
    out = capsys.readouterr().out
    assert f"[example] demo-10m: {ref_n / 1e6:.1f}M params" in out
    steps = [(int(s), float(lo), float(g)) for s, lo, g in _STEP.findall(out)]
    assert steps and steps[-1][0] == 3
    assert all(math.isfinite(lo) and math.isfinite(g) for _, lo, g in steps)
    assert math.isfinite(r["final_loss"])
    assert r["final_loss"] == pytest.approx(steps[-1][1], abs=1e-4)
    assert any(ckpt.iterdir())


_SERVED = re.compile(r"\[serve\] (\d+) sequences, (\d+) tokens")


def test_serve_lm_serves_what_the_reference_serves(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    C.load("serve_lm", "examples").main()
    want = tuple(map(int, _SERVED.search(capsys.readouterr().out).groups()))
    r = C.load("serve_lm").main(["--device", "cpu"])
    assert (r["sequences"], r["tokens"]) == want == (8, 128)
    out = capsys.readouterr().out
    assert tuple(map(int, _SERVED.search(out).groups())) == want
    assert "on cpu" in out
    assert all(len(seq) == 16 for seq in r["done"])
