"""The port's train loss and its gradients (``repro_torch.train.
value_and_grad``) against the reference's ``jax.jit(jax.value_and_grad(
model.train_loss))``, all ten SMOKE configurations, on the CPU: the same
reference weights (carried over by ``convert.lm_params_from_numpy``) and
the same seeded batch go through both, and the port's gradients are
restacked into the reference's tree (``convert.lm_params_to_numpy``) and
compared leaf by leaf.

Bounds.  At f32 (``tests/test_torch_train_grads_f32.py``): the loss within
1e-5 relative, every gradient leaf within 1e-4 of that leaf's largest
magnitude.  In bf16 (this file): the loss within 1e-3 relative and every
gradient leaf within 5e-2 of its largest magnitude.  XLA fuses the
``value_and_grad`` program differently from the serving forward, so the
rounding points the port reproduces for serving (``transformer._joined``,
``layers.add_norm``) do not all carry over to the backward pass, and a
gradient leaf sums B·S products each rounded to bf16 (eps 2^-8 = 3.9e-3)
more than once; 5e-2 is about 13 such roundings.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import registry as ref_registry
from repro.models.model import build_model as ref_build
from repro_torch import convert
from repro_torch.configs.base import registry
from repro_torch.models import build_model
from repro_torch.train import value_and_grad

ARCHS = sorted(ref_registry())
B, S = 2, 16
F32_LOSS, F32_GRAD = 1e-5, 1e-4
BF16_LOSS, BF16_GRAD = 1e-3, 5e-2


def cfgs(arch: str, dtype: str = ""):
    """The reference's and the port's SMOKE config of ``arch`` at
    ``dtype`` (default: the config's own)."""
    over = dict(dtype=dtype, param_dtype=dtype) if dtype else {}
    return (dataclasses.replace(ref_registry()[arch][1], **over),
            dataclasses.replace(registry()[arch][1], **over))


def make_batch(cfg, seed: int = 0) -> dict:
    """A seeded numpy batch: tokens, next-token labels (and frames)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def ref_leaves(tree) -> dict:
    """``{key path: float32 numpy}`` of a reference pytree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): np.asarray(
        jnp.asarray(a).astype(jnp.float32)) for path, a in flat}


def port_leaf(tree: dict, path: tuple) -> np.ndarray:
    for k in path:
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def run(arch: str, dtype: str = "") -> tuple:
    """(ref loss, port loss, ref grads by path, port grads restacked)."""
    rcfg, pcfg = cfgs(arch, dtype)
    rmodel = ref_build(rcfg)
    params, _ = rmodel.init(jax.random.PRNGKey(0))
    batch = make_batch(rcfg)
    loss, grads = jax.jit(jax.value_and_grad(rmodel.train_loss))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    pparams = convert.lm_params_from_numpy(
        pcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    ploss, pgrads = value_and_grad(
        build_model(pcfg, device="cpu"), pparams,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return (float(loss), float(ploss), ref_leaves(grads),
            convert.lm_params_to_numpy(pcfg, pgrads))


def check(arch: str, dtype: str = ""):
    rl, pl, rg, pg = run(arch, dtype)
    f32 = dtype == "float32"
    loss_tol, grad_tol = (F32_LOSS, F32_GRAD) if f32 else (BF16_LOSS,
                                                           BF16_GRAD)
    assert np.isfinite(pl)
    assert abs(pl - rl) <= loss_tol * abs(rl), (arch, pl, rl)
    for path, want in rg.items():
        got = port_leaf(pg, path)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        err = float(np.abs(got - want).max())
        assert err <= grad_tol * float(np.abs(want).max()), (arch, path, err)
    # every port gradient has its place in the reference's tree
    assert len(jax.tree_util.tree_leaves(pg)) == len(rg)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_bf16(arch):
    check(arch)
