"""The LM layers of the port (``repro_torch.models.layers`` and
``recurrent``) against the reference's (``repro.models``), on the CPU.

The same seeded numpy inputs and weights go through both.  At f32 they
agree within 1e-4 (``assert_allclose``, rtol = atol = 1e-4); in bf16
within 2e-2 of the largest reference value (``_close_bf16``).  The
reference's layers run eagerly here, one operation at a time, as the
port's do; the port's activations are written as the reference's lower
(each operation rounded), so most bf16 results are equal bit for bit.

* norms, rope, the activations against their ``torch.nn.functional``
  counterparts at f32;
* attention: in ``tests/test_torch_lm_attention.py``;
* the MLP with all three activations;
* the MoE at dropless and at dropping capacity: the dispatched expert
  buffers (which token sits in which expert's slot) equal the
  reference's exactly at f32;
* the RG-LRU block and RWKV-6's time and channel mix, with and without
  carried state, and the chunk-parallel RWKV form against the stepwise
  one (the counterpart of ``test_rwkv_chunked_matches_stepwise``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import ModelConfig as RCfg
from repro.models import layers as rL
from repro.models import recurrent as rR
from repro_torch.configs.base import ModelConfig as PCfg
from repro_torch.models import layers as pL
from repro_torch.models import recurrent as pR

F32_TOL = 1e-4
BF16_TOL = 2e-2


def _cfgs(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=2, d_ff=48, vocab=64, dtype="float32",
                param_dtype="float32")
    base.update(kw)
    return RCfg(**base), PCfg(**base)


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _j(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(pL.dtype_of(dtype))


def _close_bf16(got, want):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= BF16_TOL * np.abs(w).max(), (
        np.abs(g - w).max(), np.abs(w).max())


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        _close_bf16(got, want)


def _weights(tree, rng, dtype):
    """A dict of random weights of the given shapes, as (jax, torch)."""
    ref, port = {}, {}
    for k, (shape, scale) in tree.items():
        a = (rng.normal(size=shape) * scale).astype(np.float32)
        ref[k], port[k] = _j(a, dtype), _t(a, dtype)
    return ref, port


DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 3, 16)).astype(np.float32) * 3
    w = rng.normal(size=(16,)).astype(np.float32)
    _close(pL.rms_norm(_t(x, dtype), torch.from_numpy(w)),
           rL.rms_norm(_j(x, dtype), jnp.asarray(w)), dtype)
    pos = rng.integers(0, 5000, (2, 8)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(pL.rope(_t(x, dtype), torch.from_numpy(pos), theta),
               rL.rope(_j(x, dtype), jnp.asarray(pos), theta), dtype)
    # (T,) positions broadcast over the batch
    _close(pL.rope(_t(x, dtype), torch.from_numpy(pos[0]), 10_000.0),
           rL.rope(_j(x, dtype), jnp.asarray(pos[0]), 10_000.0), dtype)


def test_layer_norm():
    rng = np.random.default_rng(1)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((3, 5, 16), (16,), (16,)))
    _close(pL.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b)),
           rL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
           "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_activations_round_as_the_reference(dtype):
    """Each activation equals the reference's bit for bit in bf16 (every
    operation rounded as the reference's lowering rounds it), and the
    functional forms of PyTorch to rounding at f32."""
    x = np.random.default_rng(2).normal(size=4096).astype(np.float32) * 4
    pairs = [(pL.sigmoid, jax.nn.sigmoid, torch.sigmoid),
             (pL.silu, jax.nn.silu, F.silu),
             (pL.gelu_tanh, lambda v: jax.nn.gelu(v, approximate=True),
              lambda v: F.gelu(v, approximate="tanh"))]
    for port, ref, fn in pairs:
        got, want = port(_t(x, dtype)), jax.jit(ref)(_j(x, dtype))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(_np(got), fn(_t(x, dtype)).numpy(),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu_sq", False)])
def test_mlp(act, gated, dtype):
    rcfg, pcfg = _cfgs(dtype=dtype, param_dtype=dtype, mlp_act=act,
                       mlp_gated=gated)
    rng = np.random.default_rng(5)
    D, Fd = rcfg.d_model, rcfg.d_ff
    shapes = {"wi": ((D, Fd), D ** -0.5), "wo": ((Fd, D), Fd ** -0.5)}
    if gated:
        shapes["wg"] = ((D, Fd), D ** -0.5)
    rp, pp = _weights(shapes, rng, dtype)
    x = rng.normal(size=(2, 16, D)).astype(np.float32)
    _close(pL.mlp(pp, _t(x, dtype), pcfg), rL.mlp(rp, _j(x, dtype), rcfg),
           dtype)


def _moe(B, T, dtype, monkeypatch):
    rcfg, pcfg = _cfgs(dtype=dtype, param_dtype=dtype, family="moe",
                       d_model=16, d_ff=24, n_experts=8, topk=2)
    rng = np.random.default_rng(6)
    D, Fd, E = rcfg.d_model, rcfg.d_ff, rcfg.n_experts
    rp, pp = _weights({"wi": ((E, D, Fd), D ** -0.5),
                       "wg": ((E, D, Fd), D ** -0.5),
                       "wo": ((E, Fd, D), Fd ** -0.5)}, rng, dtype)
    router = (rng.normal(size=(D, E)) * D ** -0.5).astype(np.float32)
    rp["router"], pp["router"] = jnp.asarray(router), torch.from_numpy(router)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    seen = []
    from repro.models import shardctx

    def spy(a, *names):
        seen.append(a)
        return a

    monkeypatch.setattr(shardctx, "hint", spy)
    want, want_aux = rL.moe_ffn(rp, _j(x, dtype), rcfg)
    got, got_aux = pL.moe_ffn(pp, _t(x, dtype), pcfg)
    buf, meta, _ = pL._dispatch(pp, _t(x, dtype), pcfg)
    return want, want_aux, got, got_aux, seen[0], buf, meta


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,dropping", [(2, 16, False), (1, 64, False),
                                          (4, 1024, True)])
def test_moe_routing_and_drops(B, T, dropping, dtype, monkeypatch):
    """The dispatched (G, E, C, D) buffers equal the reference's exactly
    at f32: the same experts selected, the same picks kept in the same
    slots (B·T = 4096 gives 32 groups of 128 tokens: capacity 40, so
    picks are dropped)."""
    want, want_aux, got, got_aux, rbuf, buf, meta = _moe(B, T, dtype,
                                                         monkeypatch)
    G, Ng, C = pL.moe_capacity(_cfgs(n_experts=8, topk=2)[1], B * T)
    assert buf.shape == (G, 8, C, 16) == rbuf.shape
    keep = meta[3]
    assert (int(keep.sum()) < B * T * 2) == dropping
    if dtype == "float32":
        np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))
    else:
        _close_bf16(buf, rbuf)
    _close(got, want, dtype)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


def _rglru_weights(cfg, rng, dtype):
    D, W, cw = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.conv_width
    rp, pp = _weights({"wx": ((D, W), D ** -0.5), "wy": ((D, W), D ** -0.5),
                       "conv_w": ((cw, W), cw ** -0.5),
                       "conv_b": ((W,), 0.1), "wa": ((W, W), W ** -0.5),
                       "wi": ((W, W), W ** -0.5),
                       "wo": ((W, D), W ** -0.5)}, rng, dtype)
    lam = rng.uniform(0.9 ** 0.125, 0.999 ** 0.125, W).astype(np.float32)
    rp["lam"], pp["lam"] = jnp.asarray(lam), torch.from_numpy(lam)
    return rp, pp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,with_state", [(16, False), (16, True),
                                          (1, True), (37, True)])
def test_rglru_block(T, with_state, dtype):
    rcfg, pcfg = _cfgs(dtype=dtype, param_dtype=dtype, family="griffin",
                       lru_width=24, conv_width=4)
    rng = np.random.default_rng(7)
    rp, pp = _rglru_weights(rcfg, rng, dtype)
    x = rng.normal(size=(2, T, rcfg.d_model)).astype(np.float32)
    rs = ps = None
    if with_state:
        h = rng.normal(size=(2, 24)).astype(np.float32)
        conv = rng.normal(size=(2, 3, 24)).astype(np.float32)
        rs = {"h": jnp.asarray(h), "conv": _j(conv, dtype)}
        ps = {"h": torch.from_numpy(h), "conv": _t(conv, dtype)}
    want, wst = rR.rglru_block(rp, _j(x, dtype), rcfg, rs)
    got, gst = pR.rglru_block(pp, _t(x, dtype), pcfg, ps)
    _close(got, want, dtype)
    _close(gst["h"], wst["h"], dtype)
    _close(gst["conv"], wst["conv"], dtype)


def _rwkv_weights(cfg, rng, dtype):
    D, Fd, H, K = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.hd
    mix = {k: ((D,), 0.2) for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                                    "ln_w")}
    mix.update({k: ((D, D), D ** -0.5) for k in ("wr", "wk", "wv", "wg",
                                                 "wo")})
    mix.update({"wA": ((D, 64), D ** -0.5), "wB": ((64, D), 0.125)})
    rmix, pmix = _weights(mix, rng, dtype)
    for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        rmix[k], pmix[k] = rmix[k] + 0.5, pmix[k] + 0.5
    w0 = (rng.normal(size=(D,)) * 0.5 - 5.0).astype(np.float32)
    u = (rng.normal(size=(H, K)) * 0.5).astype(np.float32)
    rmix["w0"], pmix["w0"] = jnp.asarray(w0), torch.from_numpy(w0)
    rmix["u"], pmix["u"] = jnp.asarray(u), torch.from_numpy(u)
    chan = {"mu_k": ((D,), 0.2), "mu_r": ((D,), 0.2),
            "wk": ((D, Fd), D ** -0.5), "wv": ((Fd, D), Fd ** -0.5),
            "wr": ((D, D), D ** -0.5)}
    rchan, pchan = _weights(chan, rng, dtype)
    return rmix, pmix, rchan, pchan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,with_state,chunk", [(12, False, 0),
                                                (12, True, 0), (1, True, 0),
                                                (64, True, 16)])
def test_rwkv_mix_and_channel(T, with_state, chunk, dtype):
    rcfg, pcfg = _cfgs(dtype=dtype, param_dtype=dtype, family="rwkv6",
                       n_heads=4, n_kv_heads=4, head_dim=8,
                       rwkv_chunk=chunk, mlp_act="relu_sq", mlp_gated=False)
    rng = np.random.default_rng(8)
    rmix, pmix, rchan, pchan = _rwkv_weights(rcfg, rng, dtype)
    x = rng.normal(size=(2, T, rcfg.d_model)).astype(np.float32)
    rs = ps = None
    if with_state:
        S = (rng.normal(size=(2, 4, 8, 8)) * 0.3).astype(np.float32)
        xt, ct = (rng.normal(size=(2, 32)).astype(np.float32)
                  for _ in range(2))
        rs = {"S": jnp.asarray(S), "x_tail": _j(xt, dtype),
              "c_tail": _j(ct, dtype)}
        ps = {"S": torch.from_numpy(S), "x_tail": _t(xt, dtype),
              "c_tail": _t(ct, dtype)}
    want, wst = rR.rwkv_mix(rmix, _j(x, dtype), rcfg, rs)
    got, gst = pR.rwkv_mix(pmix, _t(x, dtype), pcfg, ps)
    _close(got, want, dtype)
    _close(gst["S"], wst["S"], dtype)
    _close(gst["x_tail"], wst["x_tail"], dtype)
    want, wst = rR.rwkv_channel(rchan, _j(x, dtype), rcfg, rs)
    got, gst = pR.rwkv_channel(pchan, _t(x, dtype), pcfg, ps)
    _close(got, want, dtype)
    _close(gst["c_tail"], wst["c_tail"], dtype)


def test_rwkv_chunked_matches_stepwise():
    """The port's chunk-parallel RWKV-6 form against its token-by-token
    recurrence (carried state included), and against the reference's
    chunked form, on the reference test's inputs."""
    rng = np.random.default_rng(0)
    B, T, H, K, L = 2, 96, 3, 8, 32
    mk = lambda: rng.normal(size=(B, T, H, K)).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    logw = (-np.exp(rng.normal(-1.5, 1.0, (B, T, H, K)))).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32)
    S0 = (rng.normal(size=(B, H, K, K)) * 0.3).astype(np.float32)
    t = torch.from_numpy
    S_s, o_s = pR._rwkv_steps(t(r), t(k), t(v), t(np.exp(logw)), t(S0),
                              t(u))
    S_c, o_c = pR._rwkv_chunked(t(r), t(k), t(v), t(logw), t(S0), t(u), L)
    np.testing.assert_allclose(o_c.numpy(), o_s.numpy(), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(S_c.numpy(), S_s.numpy(), rtol=3e-4,
                               atol=3e-4)
    S_r, o_r = rR._rwkv_chunked(*(jnp.asarray(a) for a in
                                  (r, k, v, logw, S0, u)), L)
    np.testing.assert_allclose(o_c.numpy(), np.asarray(o_r), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(S_c.numpy(), np.asarray(S_r), rtol=F32_TOL,
                               atol=F32_TOL)


def test_add_norm_reads_the_unrounded_sum():
    """``add_norm`` equals the reference's compiled ``rms_norm(x + h)``:
    XLA moves the convert ahead of the add, so the norm reads the sum
    before it is rounded to bf16; the residual itself is rounded."""
    rng = np.random.default_rng(9)
    x, h = (rng.normal(size=(4, 64)).astype(np.float32) for _ in range(2))
    w = (rng.normal(size=(64,)) * 0.1).astype(np.float32)

    def ref(x, h, w):
        s = x + h
        return s, rL.rms_norm(s, w)

    want_s, want_n = jax.jit(ref)(_j(x, "bfloat16"), _j(h, "bfloat16"),
                                  jnp.asarray(w))
    got_s, got_n = pL.add_norm(_t(x, "bfloat16"), _t(h, "bfloat16"),
                               torch.from_numpy(w))
    np.testing.assert_array_equal(_np(got_s), _np(want_s))
    np.testing.assert_array_equal(_np(got_n), _np(want_n))
