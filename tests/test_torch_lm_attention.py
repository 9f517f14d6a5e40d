"""Attention of the port (``repro_torch.models.layers.attention``) against
the reference's, on the CPU, with the helpers and tolerances of
``tests/test_torch_lm_layers.py`` (f32 within 1e-4, bf16 within 2e-2 of
the largest reference value):

* every kind: global (with q/k norms and the logit soft cap), local,
  bidir, cross, and the chunked online softmax at S = 3072 (global and
  windowed);
* the decode caches: prefill then decode steps, every output and the
  cache leaf by leaf (the port's (B, N, S, K) buffers read in the
  reference's (B, S, N, K)): the local ring before and after it wraps,
  a prefill past the window (a rolled ring) and of exactly the window,
  the global cache, and decoding past ``S_max``, where the reference's
  ``dynamic_update_slice`` clamps its start onto the last slot; each in
  f32, in bf16 and with an f8 cache.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as rL
from repro_torch.models import layers as pL
from test_torch_lm_layers import DTYPES, _cfgs, _close, _j, _t, _weights


def _attn_weights(cfg, rng, dtype):
    D, H, N, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = {"wq": ((D, H, K), D ** -0.5), "wk": ((D, N, K), D ** -0.5),
              "wv": ((D, N, K), D ** -0.5), "wo": ((H, K, D), (H * K) ** -0.5)}
    if cfg.qk_norm:
        shapes["q_norm"] = ((K,), 0.1)
        shapes["k_norm"] = ((K,), 0.1)
    return _weights(shapes, rng, dtype)


ATTN_CASES = [
    # kind, cfg overrides, B, T, S of the kv input (cross)
    ("global", {}, 2, 16, None),
    ("global", {"qk_norm": True, "softcap_attn": 50.0}, 2, 16, None),
    ("local", {"window": 6}, 2, 16, None),
    ("bidir", {}, 2, 16, None),
    ("cross", {}, 2, 8, 24),
    ("global", {"n_heads": 2, "n_kv_heads": 1, "d_model": 16}, 1, 3072,
     None),                                          # chunked (S > 2048)
    ("local", {"n_heads": 2, "n_kv_heads": 1, "d_model": 16,
               "window": 1500}, 1, 3072, None),      # chunked, windowed
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,over,B,T,S", ATTN_CASES,
                         ids=[f"{c[0]}-{c[3]}-{i}"
                              for i, c in enumerate(ATTN_CASES)])
def test_attention_kinds(kind, over, B, T, S, dtype):
    rcfg, pcfg = _cfgs(dtype=dtype, param_dtype=dtype, **over)
    rng = np.random.default_rng(3)
    rp, pp = _attn_weights(rcfg, rng, dtype)
    x = rng.normal(size=(B, T, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    kw_r, kw_p = {}, {}
    if S:
        kv = rng.normal(size=(B, S, rcfg.d_model)).astype(np.float32)
        kw_r["kv_x"], kw_p["kv_x"] = _j(kv, dtype), _t(kv, dtype)
    want, _ = rL.attention(rp, _j(x, dtype), rcfg, kind, jnp.asarray(pos),
                           **kw_r)
    got, _ = pL.attention(pp, _t(x, dtype), pcfg, kind, torch.from_numpy(pos),
                          **kw_p)
    _close(got, want, dtype)


def _ref_cache(cfg, B, S, window):
    N, K = cfg.n_kv_heads, cfg.hd
    dt = jnp.dtype(cfg.cache_dtype or cfg.dtype)
    W = window or S
    return rL.KVCache(jnp.zeros((B, W, N, K), dt), jnp.zeros((B, W, N, K), dt),
                      jnp.zeros((), jnp.int32), window)


def _port_cache(cfg, B, S, window):
    N, K = cfg.n_kv_heads, cfg.hd
    dt = pL.dtype_of(cfg.cache_dtype or cfg.dtype)
    W = window or S
    return pL.KVCache(torch.zeros((B, N, W, K), dtype=dt),
                      torch.zeros((B, N, W, K), dtype=dt),
                      torch.zeros((), dtype=torch.int32), window)


def _same_cache(pc, rc, dtype):
    _close(pc.k.permute(0, 2, 1, 3), rc.k, dtype)
    _close(pc.v.permute(0, 2, 1, 3), rc.v, dtype)
    assert int(pc.pos) == int(rc.pos)


CACHE_CASES = [
    # kind, window (0 global), S_max, prompt T, decode steps
    ("local", 8, 24, 5, 6),     # ring fills and wraps while decoding
    ("local", 8, 24, 13, 5),    # prefill past the window: a rolled ring
    ("local", 8, 24, 8, 3),     # prefill exactly the window
    ("global", 0, 12, 6, 4),
    ("global", 0, 8, 6, 4),     # decode past S_max: the start is clamped
]


@pytest.mark.parametrize("dtype", DTYPES + ["float8"])
@pytest.mark.parametrize("kind,W,S,T,n", CACHE_CASES,
                         ids=[f"{c[0]}-W{c[1]}-S{c[2]}-T{c[3]}"
                              for c in CACHE_CASES])
def test_attention_cache_prefill_and_decode(kind, W, S, T, n, dtype):
    """Prefill then decode steps against the reference's cache, leaf by
    leaf (the port's (B, N, S, K) cache read in the reference's layout),
    and the outputs at every step; f8 is a bf16 model with an f8 cache."""
    cache_dtype = "float8_e4m3fn" if dtype == "float8" else ""
    dtype = "bfloat16" if dtype == "float8" else dtype
    rcfg, pcfg = _cfgs(dtype=dtype, param_dtype=dtype, window=W or 4096,
                       cache_dtype=cache_dtype)
    rng = np.random.default_rng(4)
    rp, pp = _attn_weights(rcfg, rng, dtype)
    B = 2
    x = rng.normal(size=(B, T + n, rcfg.d_model)).astype(np.float32)
    rc, pc = _ref_cache(rcfg, B, S, W), _port_cache(pcfg, B, S, W)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    want, rc = rL.attention(rp, _j(x[:, :T], dtype), rcfg, kind,
                            jnp.asarray(pos), cache=rc)
    got, pc = pL.attention(pp, _t(x[:, :T], dtype), pcfg, kind,
                           torch.from_numpy(pos), cache=pc)
    _close(got, want, dtype)
    _same_cache(pc, rc, dtype)
    for t in range(T, T + n):
        qp = np.full((B, 1), t, np.int32)
        want, rc = rL.attention(rp, _j(x[:, t:t + 1], dtype), rcfg, kind,
                                jnp.asarray(qp), cache=rc)
        got, pc = pL.attention(pp, _t(x[:, t:t + 1], dtype), pcfg, kind,
                               torch.from_numpy(qp), cache=pc)
        _close(got, want, dtype)
        _same_cache(pc, rc, dtype)
