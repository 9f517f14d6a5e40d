"""The port's LM stack (``repro_torch.models``) against the reference's, all
ten SMOKE configurations, on the CPU: the same reference weights (carried
over by ``convert.lm_params_from_numpy``) and the same seeded tokens and
frames go through both.

For each architecture: the full forward's logits, the prefill's last
logits and its caches (leaf by leaf, in the reference's layout: ring
buffers included), and 8 decode steps' logits and the caches after them.
The reference runs compiled (``jax.jit``), as its serving path runs it;
the port reproduces where XLA rounds a bf16 result and where it reads it
unrounded (``layers.add_norm``).  This file holds each configuration at
its own dtype (bf16: within 2e-2 of the largest reference value, as
``tests/test_torch_lm_layers.py`` measures it) and the f8 cache;
``tests/test_torch_lm_models_f32.py`` holds all ten at f32 (within 1e-4).
Also: the port's own prefill/decode consistency (the counterpart of
``test_prefill_decode_consistency``), the weights carried over bit for
bit, the layer plan against the reference's trees, and the prefill's
last-position unembedding against the reference's full logits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import registry as ref_registry
from repro.models import encdec as rE
from repro.models import layers as rL
from repro.models import transformer as rT
from repro.models.model import build_model as ref_build
from repro_torch import convert
from repro_torch.configs.base import registry
from repro_torch.models import build_model, encdec, transformer

ARCHS = sorted(ref_registry())
B, S = 2, 16
HALF = S // 2
F32_TOL = 1e-4
BF16_TOL = 2e-2


def cfgs(arch: str, dtype: str = "", **over):
    """The reference's and the port's SMOKE config of ``arch``, at
    ``dtype`` (default: the config's own)."""
    rc, pc = ref_registry()[arch][1], registry()[arch][1]
    if dtype:
        over.update(dtype=dtype, param_dtype=dtype)
    return dataclasses.replace(rc, **over), dataclasses.replace(pc, **over)


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    a = jnp.asarray(a)
    if jnp.issubdtype(a.dtype, jnp.floating):
        a = a.astype(jnp.float32)
    return np.asarray(a)


def ref_cache_numpy(tree):
    """The reference's cache pytree as nested dicts of numpy (a
    ``KVCache`` as ``{"k", "v", "pos"}``, floats as float32)."""
    if isinstance(tree, rL.KVCache):
        return {"k": _np(tree.k), "v": _np(tree.v), "pos": _np(tree.pos)}
    if isinstance(tree, dict):
        return {k: ref_cache_numpy(v) for k, v in tree.items()}
    return _np(tree)


def flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}/{k}"))
        return out
    return {pre: tree}


def close(got, want, dtype: str, what: str = ""):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
    else:
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= BF16_TOL * scale, (what, err, scale)


def same_caches(port_tree, ref_tree, dtype: str, what: str):
    a, b = flat(port_tree), flat(ref_tree)
    assert a.keys() == b.keys(), (what, sorted(a), sorted(b))
    for k in b:
        if k.endswith("/pos"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=what + k)
        else:
            close(a[k], b[k], dtype, what + k)


def inputs(cfg):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
              .astype(np.float32) if cfg.family == "encdec" else None)
    return tokens, frames


def port_params(pcfg, params):
    return convert.lm_params_from_numpy(
        pcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")


@functools.lru_cache(maxsize=None)
def run(arch: str, dtype: str = "", cache_dtype: str = "") -> dict:
    """Both packages over one set of weights and inputs: full logits,
    prefill logits and caches, 8 decode steps' logits, final caches."""
    rcfg, pcfg = cfgs(arch, dtype, cache_dtype=cache_dtype)
    rm, pm = ref_build(rcfg), build_model(pcfg, device="cpu")
    params, _ = rm.init(jax.random.PRNGKey(1))
    pp = port_params(pcfg, params)
    tokens, frames = inputs(rcfg)
    tt = torch.from_numpy(tokens)
    out = {"ref": {}, "port": {}}
    if rcfg.family == "encdec":
        fr, pfr = jnp.asarray(frames), torch.from_numpy(frames)
        full = jax.jit(lambda p, t, f: rE._decoder(
            p, rcfg, t, rE.forward_encoder(p, rcfg, f))[0])(params, tokens, fr)
        pfull, _ = encdec._decoder(pp, pcfg, tt,
                                   encdec.forward_encoder(pp, pcfg, pfr))
        lp, rc, renc = jax.jit(rm.prefill, static_argnames="max_len")(
            params, tokens[:, :HALF], fr, max_len=S)
        plp, pc, penc = pm.prefill(pp, tt[:, :HALF], pfr, max_len=S)
        rest, prest = (renc,), (penc,)
    else:
        full = jax.jit(lambda p, t: rT.forward(p, rcfg, t)[0])(params, tokens)
        pfull, _, _ = transformer.forward(pp, pcfg, tt)
        lp, rc = jax.jit(rm.prefill, static_argnames="max_len")(
            params, tokens[:, :HALF], max_len=S)
        plp, pc = pm.prefill(pp, tt[:, :HALF], max_len=S)
        rest, prest = (), ()
    out["ref"]["full"], out["port"]["full"] = _np(full), _np(pfull)
    out["ref"]["prefill"], out["port"]["prefill"] = _np(lp), _np(plp)
    out["ref"]["cache0"] = ref_cache_numpy(rc)
    out["port"]["cache0"] = convert.lm_cache_to_numpy(pcfg, pc)
    dec = jax.jit(rm.decode_step)
    out["ref"]["decode"], out["port"]["decode"] = [], []
    for t in range(HALF, S):
        ld, rc = dec(params, rc, tokens[:, t:t + 1], jnp.int32(t), *rest)
        pld, pc = pm.decode_step(pp, pc, tt[:, t:t + 1], t, *prest)
        out["ref"]["decode"].append(_np(ld))
        out["port"]["decode"].append(_np(pld))
    out["ref"]["cache1"] = ref_cache_numpy(rc)
    out["port"]["cache1"] = convert.lm_cache_to_numpy(pcfg, pc)
    out["dtype"] = pcfg.dtype
    return out


def check_forward(arch, dtype=""):
    r = run(arch, dtype)
    close(r["port"]["full"], r["ref"]["full"], r["dtype"], arch)


def check_prefill(arch, dtype=""):
    r = run(arch, dtype)
    close(r["port"]["prefill"], r["ref"]["prefill"], r["dtype"], arch)
    same_caches(r["port"]["cache0"], r["ref"]["cache0"], r["dtype"], arch)


def check_decode(arch, dtype=""):
    r = run(arch, dtype)
    assert len(r["port"]["decode"]) == S - HALF == 8
    for i, (g, w) in enumerate(zip(r["port"]["decode"], r["ref"]["decode"])):
        close(g, w, r["dtype"], f"{arch} step {i}")
    same_caches(r["port"]["cache1"], r["ref"]["cache1"], r["dtype"], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches(arch):
    check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches(arch):
    check_decode(arch)


def test_f8_cache():
    """qwen3 with ``cache_dtype="float8_e4m3fn"``: the port writes its f8
    cache at device indices through the bytes; prefill, decode and the
    cache contents agree with the reference's."""
    check_prefill("qwen3-1.7b", "")
    r = run("qwen3-1.7b", "", "float8_e4m3fn")
    close(r["port"]["prefill"], r["ref"]["prefill"], "bfloat16")
    same_caches(r["port"]["cache0"], r["ref"]["cache0"], "bfloat16", "f8")
    for g, w in zip(r["port"]["decode"], r["ref"]["decode"]):
        close(g, w, "bfloat16", "f8 decode")
    same_caches(r["port"]["cache1"], r["ref"]["cache1"], "bfloat16", "f8")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_decode_consistency(arch):
    """Decoding token by token matches the port's own full forward, as the
    reference's ``test_prefill_decode_consistency`` holds the reference
    (its tolerance, its shapes)."""
    _, pcfg = cfgs(arch)
    model = build_model(pcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    tokens, frames = inputs(pcfg)
    tt = torch.from_numpy(tokens)
    if pcfg.family == "encdec":
        fr = torch.from_numpy(frames)
        full, _ = encdec._decoder(params, pcfg, tt,
                                  encdec.forward_encoder(params, pcfg, fr))
        lp, caches, enc = model.prefill(params, tt[:, :HALF], fr, max_len=S)
        rest = (enc,)
    else:
        full, _, _ = transformer.forward(params, pcfg, tt)
        lp, caches = model.prefill(params, tt[:, :HALF], max_len=S)
        rest = ()
    np.testing.assert_allclose(lp[:, -1].float().numpy(),
                               full[:, HALF - 1].numpy(), rtol=2e-2,
                               atol=2e-2)
    for t in range(HALF, S):
        ld, caches = model.decode_step(params, caches, tt[:, t:t + 1], t,
                                       *rest)
        np.testing.assert_allclose(ld[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-2, atol=2e-2,
                                   err_msg=f"{arch}: decode step {t}")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-large-v3",
                                  "recurrentgemma-9b"])
def test_weights_carry_over_bit_for_bit(arch):
    """Every reference leaf reaches the port with its dtype and bits (a
    bf16 leaf through its 16-bit pattern), the stacks unstacked."""
    rcfg, pcfg = cfgs(arch)
    params, _ = ref_build(rcfg).init(jax.random.PRNGKey(2))
    pp = port_params(pcfg, params)
    ref_leaves = jax.tree_util.tree_leaves(params)
    assert sum(p.numel() for p in pp.parameters()) == sum(
        x.size for x in ref_leaves)
    emb = np.asarray(params["embed"])
    assert str(emb.dtype) == "bfloat16" and pp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pp["embed"].view(torch.int16).numpy(),
                                  emb.view(np.int16))
    if arch == "whisper-large-v3":
        wq = np.asarray(params["dec"]["attn"]["wq"])[1]
        got = pp["dec"][1]["attn"]["wq"]
    else:
        path = transformer.layer_paths(pcfg)[-1]
        blk = (jax.tree_util.tree_map(lambda a: np.asarray(a)[path[2]],
                                      params["scan"][path[1]])
               if path[0] == "scan" else params[path[0]])
        key = "rec" if "rec" in blk else "attn"
        name = "wx" if key == "rec" else "wq"
        wq, got = np.asarray(blk[key][name]), pp["blocks"][-1][key][name]
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq.view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_plan_matches_the_reference_trees(arch):
    """``layer_paths`` names every block of the reference's parameter
    tree once, in layer order, and the port's caches come back in the
    reference's cache tree."""
    rcfg, pcfg = cfgs(arch)
    if rcfg.family == "encdec":   # one stack per side, no plan
        got = convert.lm_cache_to_numpy(pcfg,
                                        encdec.init_cache(pcfg, 2, 8, "cpu"))
        ref = ref_cache_numpy(rE.init_cache(rcfg, 2, 8))
    else:
        params, _ = ref_build(rcfg).init(jax.random.PRNGKey(0))
        paths = transformer.layer_paths(pcfg)
        assert len(paths) == pcfg.n_layers
        want = {k for k in params if k == "scan" or k.startswith("rest")}
        assert {p[0] for p in paths} == want
        got = convert.lm_cache_to_numpy(
            pcfg, transformer.init_cache(pcfg, 2, 8, "cpu"))
        ref = ref_cache_numpy(rT.init_cache(rcfg, 2, 8))
    assert {k: v.shape for k, v in flat(got).items()} == {
        k: v.shape for k, v in flat(ref).items()}


def test_prefill_unembeds_the_last_position_only():
    """The prefill unembeds the last position alone; it equals the last
    row of the reference's full logits (rows are independent), and
    ``forward(last=k)`` equals the last k rows of the port's full logits."""
    rcfg, pcfg = cfgs("gemma2-2b", "float32")
    params, _ = ref_build(rcfg).init(jax.random.PRNGKey(3))
    pp = port_params(pcfg, params)
    tokens, _ = inputs(rcfg)
    full = np.asarray(rT.forward(params, rcfg, jnp.asarray(tokens))[0])
    lp, _ = build_model(pcfg, device="cpu").prefill(
        pp, torch.from_numpy(tokens))
    assert lp.shape == (B, 1, pcfg.vocab_padded)
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, -1], rtol=F32_TOL,
                               atol=F32_TOL)
    pfull, _, _ = transformer.forward(pp, pcfg, torch.from_numpy(tokens))
    last3, _, _ = transformer.forward(pp, pcfg, torch.from_numpy(tokens),
                                      last=3)
    np.testing.assert_array_equal(last3.numpy(), pfull[:, -3:].numpy())
