"""AdamW (``repro_torch.train.optimizer``) against the reference's, on the
CPU.

The same parameters, gradients (seeded numpy) and state go through the
reference's ``adamw_update`` and the port's, over six steps that cross
the warmup boundary, with the gradients scaled so that clipping acts on
some steps and not on others: parameters, ``m``, ``v``, ``grad_norm`` and
``lr`` agree within 1e-6 relative after every step.  AdamW is held alone
like this because a whole train step compared after its update amplifies
tiny gradient differences (at step 1, ``mhat / sqrt(vhat)`` is about
``sign(g)``).  The configurations are at f32 (the parameters' cast back
to bf16 would turn a 1e-7 difference into a rounding flip) and cover the
three layouts: scanned superblocks, remainder layers, encdec stacks.

The decay mask: the reference decays a leaf of two or more dimensions of
its *stacked* tree; the port's mask, read from each parameter's place in
that tree, is held against it leaf by leaf for all ten configurations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import registry as ref_registry
from repro.models.model import build_model as ref_build
from repro.train import optimizer as ropt
from repro_torch import convert
from repro_torch.configs.base import registry
from repro_torch.models import build_model
from repro_torch.models.model import ref_location
from repro_torch.train import optimizer as popt

ARCHS = sorted(ref_registry())
TOL = 1e-6


def _f32(arch):
    over = dict(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(ref_registry()[arch][1], **over),
            dataclasses.replace(registry()[arch][1], **over))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _same_tree(port: dict, ref, what: str):
    for path, a in jax.tree_util.tree_flatten_with_path(ref)[0]:
        b = port
        for k in path:
            b = b[k.key]
        _close(b, np.asarray(a), f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-9b",
                                  "whisper-large-v3"])
def test_adamw_matches_reference_across_warmup(arch):
    rcfg, pcfg = _f32(arch)
    params, _ = ref_build(rcfg).init(jax.random.PRNGKey(0))
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=8)
    rcfg_o, pcfg_o = ropt.AdamWConfig(**cfg), popt.AdamWConfig(**cfg)
    pparams = convert.lm_params_from_numpy(
        pcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rstate = ropt.init_opt_state(params)
    pstate = popt.init_opt_state(pparams)
    rng = np.random.default_rng(1)
    update = jax.jit(lambda p, g, s: ropt.adamw_update(p, g, s, rcfg_o))
    for step in range(6):
        # large gradients on even steps (clipped), small on odd ones
        scale = 10.0 if step % 2 == 0 else 1e-3
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
            params)
        params, rstate, rm = update(params, grads, rstate)
        pg = dict(convert.lm_params_from_numpy(
            pcfg, grads, device="cpu").named_parameters())
        pparams, pstate, pm = popt.adamw_update(pparams, pg, pstate,
                                                pcfg_o)
        what = f"{arch} step {step + 1}"
        _close(float(pm["lr"]), float(rm["lr"]), what + " lr")
        _close(float(pm["grad_norm"]), float(rm["grad_norm"]),
               what + " grad_norm")
        assert int(pstate["step"]) == int(rstate["step"]) == step + 1
        _same_tree(convert.lm_params_to_numpy(pcfg, pparams), params,
                   what + " params")
        ps = convert.opt_state_to_numpy(pcfg, pstate)
        _same_tree(ps["m"], rstate["m"], what + " m")
        _same_tree(ps["v"], rstate["v"], what + " v")


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_the_references_stacked_tree(arch):
    rcfg, pcfg = ref_registry()[arch][1], registry()[arch][1]
    shapes = jax.eval_shape(
        lambda: ref_build(rcfg).init(jax.random.PRNGKey(0))[0])
    want = {tuple(k.key for k in path): leaf.ndim >= 2
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}
    params = build_model(pcfg, device="cpu").init()
    mask = popt.decay_mask(params)
    seen = set()
    for name, decayed in mask.items():
        path, _ = ref_location(pcfg, name)
        assert decayed == want[path], (arch, name, path)
        seen.add(path)
    assert seen == set(want), (arch, set(want) - seen)
    # vectors inside a stacked layer are decayed; ln_f is not
    assert not mask["ln_f"]
    if rcfg.family == "encdec":
        assert mask["enc.0.ln1"] and mask["dec.0.ln2"]


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 8, 20])
def test_schedule_matches_reference(step):
    cfg = dict(lr=3e-3, warmup_steps=3, total_steps=10)
    want = float(ropt.schedule(ropt.AdamWConfig(**cfg),
                               jnp.asarray(step, jnp.int32)))
    got = float(popt.schedule(popt.AdamWConfig(**cfg),
                              torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=TOL, abs=1e-12)


def test_opt_state_round_trips_through_the_references_layout():
    _, pcfg = _f32("qwen3-1.7b")
    params = build_model(pcfg, device="cpu").init()
    state = popt.init_opt_state(params)
    g = torch.Generator().manual_seed(3)
    for t in (*state["m"].values(), *state["v"].values()):
        t.copy_(torch.randn(t.shape, generator=g))
    state["step"].fill_(7)
    ref = convert.opt_state_to_numpy(pcfg, state)
    back = convert.opt_state_from_numpy(pcfg, ref,
                                        popt.init_opt_state(params))
    assert int(back["step"]) == 7
    for k in ("m", "v"):
        for n, t in state[k].items():
            assert torch.equal(back[k][n], t), (k, n)
