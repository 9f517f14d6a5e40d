"""The port's training loop on the CPU: mirrors of the training tests of
``tests/test_checkpoint_train.py`` (resume is exact, the loss decreases on
learnable data, microbatched gradients match the full batch) and of
``tests/test_arch_smoke.py::test_train_step_shapes_and_finite`` (all ten
architectures), the data pipelines against the reference's, and
``python -m repro_torch.launch.train`` cut at a checkpoint and relaunched.
"""
import os
import shutil
import tempfile
import warnings

import numpy as np
import pytest
import torch

from repro.configs.base import registry as ref_registry
from repro.core import compile as rqc
from repro.core.frontend import TStream as RTStream
from repro.data import pipeline as rpipe
from repro_torch.configs.base import registry
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream
from repro_torch.data import pipeline as pipe
from repro_torch.data.tolerance import compare
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ck
from repro_torch.train import value_and_grad
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

ARCHS = sorted(registry())


def _setup(arch: str, seed: int):
    cfg = registry()[arch][1]
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    return cfg, model, params, init_opt_state(params)


def _live(params, opt):
    return {"params": dict(params.named_parameters()), "opt": opt}


def test_train_resume_is_exact():
    """Train 6 steps straight vs 3 + checkpoint + restore + 3: identical."""
    cfg, model, params, opt = _setup("granite-8b", 0)
    step_fn = make_train_step(model, AdamWConfig(lr=1e-3))

    def run(params, opt, p, n):
        for _ in range(n):
            params, opt, m = step_fn(params, opt, p.next())
        return params, opt, m

    start = {k: v.clone() for k, v in ck._flatten(_live(params, opt)).items()}
    pa, oa, ma = run(params, opt, pipe.TokenPipeline(cfg, 2, 32, seed=3,
                                                     device="cpu"), 6)
    a = {k: v.clone() for k, v in ck._flatten(_live(pa, oa)).items()}

    _, _, pb, ob = _setup("granite-8b", 0)
    for k, t in ck._flatten(_live(pb, ob)).items():
        assert torch.equal(t, start[k])
    pipe_b = pipe.TokenPipeline(cfg, 2, 32, seed=3, device="cpu")
    pb, ob, _ = run(pb, ob, pipe_b, 3)
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 3, _live(pb, ob), extra={"pipeline": pipe_b.state()})
        _, _, pc, oc = _setup("granite-8b", 9)      # other weights
        _, manifest = ck.restore(d, into=_live(pc, oc))
        pipe_c = pipe.TokenPipeline(cfg, 2, 32, device="cpu")
        pipe_c.restore(manifest["extra"]["pipeline"])
        pc, oc, mc = run(pc, oc, pipe_c, 3)

    for k, t in ck._flatten(_live(pc, oc)).items():
        assert torch.equal(t, a[k]), k
    assert float(ma["loss"]) == pytest.approx(float(mc["loss"]), rel=1e-6)


def test_loss_decreases_on_learnable_data():
    cfg, model, params, opt = _setup("qwen3-1.7b", 1)
    step_fn = make_train_step(
        model, AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40))
    p = pipe.TokenPipeline(cfg, 4, 64, seed=5, device="cpu")
    first = None
    for i in range(25):
        params, opt, m = step_fn(params, opt, p.next())
        if i == 0:
            first = float(m["loss"])
    assert float(m["loss"]) < first - 0.1, (first, float(m["loss"]))


def test_microbatched_grads_match_full_batch():
    cfg, model, params, opt = _setup("granite-8b", 2)
    batch = pipe.TokenPipeline(cfg, 4, 32, seed=9, device="cpu").next()
    saved = {k: v.clone() for k, v in ck._flatten(_live(params, opt)).items()}
    _, _, m1 = make_train_step(model, AdamWConfig(), n_micro=1)(
        params, opt, batch)
    for k, t in ck._flatten(_live(params, opt)).items():
        with torch.no_grad():
            t.copy_(saved[k])
    _, _, m2 = make_train_step(model, AdamWConfig(), n_micro=2)(
        params, opt, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=2e-3)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]),
                                                   rel=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_shapes_and_finite(arch):
    """One step of every architecture: a finite loss, finite nonzero
    gradients of the parameters' shapes and dtypes, parameters updated in
    place, moments in f32, the step counted."""
    cfg, model, params, opt = _setup(arch, 0)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                      generator=g)
    loss, grads = value_and_grad(model, params, batch)
    assert np.isfinite(float(loss)), f"{arch}: loss {loss}"
    named = dict(params.named_parameters())
    assert grads.keys() == named.keys()
    for n, gr in grads.items():
        assert gr.shape == named[n].shape and gr.dtype == named[n].dtype, n
    gnorm = sum(float(torch.sum(torch.square(gr.float())))
                for gr in grads.values())
    assert np.isfinite(gnorm) and gnorm > 0, f"{arch}: grad norm {gnorm}"
    before = {n: p.detach().clone() for n, p in named.items()}
    ptrs = {n: p.data_ptr() for n, p in named.items()}
    params2, opt2, m = make_train_step(model)(params, opt, batch)
    assert params2 is params and opt2 is opt and int(opt["step"]) == 1
    assert float(m["loss"]) == pytest.approx(float(loss), rel=1e-6)
    assert all(p.data_ptr() == ptrs[n] for n, p in named.items())
    assert any(not torch.equal(p, before[n]) for n, p in named.items())
    assert all(t.dtype == torch.float32 for t in opt["m"].values())


# ---------------------------------------------------------------------------
# data pipelines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-large-v3"])
def test_token_pipeline_yields_the_references_batches(arch):
    rcfg, pcfg = ref_registry()[arch][1], registry()[arch][1]
    ref = rpipe.TokenPipeline(rcfg, 3, 17, seed=4)
    port = pipe.TokenPipeline(pcfg, 3, 17, seed=4, device="cpu")
    for _ in range(3):
        want, got = ref.next(), port.next()
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == {"frames": torch.float32}.get(
                k, torch.int32)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
    assert port.state() == ref.state() == {"step": 3, "seed": 4}
    other = pipe.TokenPipeline(pcfg, 3, 17, device="cpu")
    other.restore(port.state())
    ref_next = ref.next()
    for k, v in other.next().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_next[k]))


def _feature_query(ts):
    s = ts.source("x")
    return s.window(8).mean().join(s.window(32).mean(), lambda a, b: a - b)


def test_stream_feature_pipeline_matches_the_reference_across_restore():
    """Both packages' feature pipelines over one compiled query: 2 steps,
    then the state into a new pipeline, 2 more; every output within the
    apps' tolerance of the reference's (``data.tolerance``, trend)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = rpipe.StreamFeaturePipeline(rqc.compile_query(
            _feature_query(RTStream).node, out_len=64, pallas=False),
            gen_seed=2)
        exe = qc.compile_query(_feature_query(TStream).node, out_len=64)
        port = pipe.StreamFeaturePipeline(exe, gen_seed=2, device="cpu")
        outs = [(port.next(), ref.next()) for _ in range(2)]
        resumed = pipe.StreamFeaturePipeline(exe, gen_seed=2, device="cpu")
        resumed.restore(port.state())
        assert resumed.step == 2
        outs += [(resumed.next(), ref.next()) for _ in range(2)]
    for got, want in outs:
        compare("trend", got.valid.numpy(), {"v": got.value.numpy()},
                np.asarray(want.valid), {"v": np.asarray(want.value)})
        assert got.valid.any()


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

def test_launch_train_cut_at_a_checkpoint_resumes_to_the_same_loss(capsys):
    """`launch.train.main` at SMOKE, 6 steps with a checkpoint every 3: a
    run cut after step 3's checkpoint (the later one removed, the pointer
    back at 3) and relaunched restores step 3 and ends with the
    uninterrupted run's loss, bit for bit."""
    args = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "6", "--batch",
            "2", "--seq", "16", "--ckpt-every", "3", "--log-every", "1",
            "--device", "cpu"]
    with tempfile.TemporaryDirectory() as d:
        full = launch_train.main(args + ["--ckpt-dir", f"{d}/a"])
        cut = f"{d}/b"
        launch_train.main(args + ["--ckpt-dir", cut])
        shutil.rmtree(os.path.join(cut, "step_6"))
        with open(os.path.join(cut, "latest"), "w") as f:
            f.write("3")
        resumed = launch_train.main(args + ["--ckpt-dir", cut])
        a, _ = ck.restore(f"{d}/a", device="cpu")
        b, _ = ck.restore(cut, device="cpu")
    out = capsys.readouterr().out
    assert "[train] restored step 3" in out
    assert "[train] step 6 loss" in out and "gnorm" in out
    assert resumed == full and np.isfinite(full)
    for k, t in ck._flatten(a).items():
        assert torch.equal(t, ck._flatten(b)[k]), k
