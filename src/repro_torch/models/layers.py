"""Model-layer primitives shared by all 10 architectures (port of
``repro.models.layers``).

Parameters live in :class:`Params`, an ``nn.Module`` whose parameters and
children keep the reference's names, so a layer reads ``p["wq"]`` or
``p["attn"]["wq"]`` whether it is given a module or a plain dict of
tensors.  The layers are plain functions on tensors, as in the reference:
``init_*(gen, cfg, device) -> dict`` draws the parameters from an explicit
``torch.Generator`` and ``apply(p, x, ...)`` computes.

Conventions: B batch, T query time, S key time, D d_model, F d_ff,
H q-heads, N kv-heads, G = H//N group size, K head_dim, E experts, C expert
capacity.  Params are ``param_dtype``; activations ``dtype``; softmax/norm
statistics in f32.  Every product rounds where the reference's does: an
einsum in ``x.dtype`` gives ``x.dtype`` (attention scores are cast to f32
only after it), and a constant the reference makes in ``x.dtype`` is
rounded to it first.

Decode state is written in place: a :class:`KVCache` holds its buffers
and its ``pos`` (an int32 tensor on the device), and a cache write goes to
a slot computed on the device (``index_copy_``), never through a host
read, so a decode step can be captured in a CUDA graph.  The cache keeps
the heads ahead of time, ``(B, N, S, K)``, so that attention reads it as
matmul operands without a copy; :func:`repro_torch.convert.lm_cache_to_numpy`
gives it back in the reference's ``(B, S, N, K)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig

__all__ = [
    "Params", "dtype_of", "rms_norm", "add_norm", "layer_norm", "rope", "init_attention",
    "attention", "init_mlp", "mlp", "init_moe", "moe_ffn", "KVCache",
    "sigmoid", "silu", "gelu_tanh",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


def _dt(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.dtype)


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


def _init(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32) * scale).to(dtype)


class Params(nn.Module):
    """A tree of parameters under the reference's names: ``p["attn"]["wq"]``.

    Nested dicts become child ``Params``; tensors become parameters that
    take no gradient (this is the serving path)."""

    def __init__(self, tree: Optional[dict] = None):
        super().__init__()
        for k, v in (tree or {}).items():
            self[k] = v

    def __setitem__(self, key: str, value):
        if isinstance(value, dict):
            value = Params(value)
        if isinstance(value, nn.Module):
            self.add_module(key, value)
        else:
            self.register_parameter(
                key, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The parameters as nested dicts of tensors."""
        out = {k: v for k, v in self._parameters.items()}
        for k, m in self._modules.items():
            if isinstance(m, nn.ModuleList):
                out[k] = [c.tree() for c in m]
            else:
                out[k] = m.tree()
        return out


# ---------------------------------------------------------------------------
# norms & rope
# ---------------------------------------------------------------------------

def _rms32(x32, w, eps: float):
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)) * (1.0 + w.float())


def rms_norm(x, w, eps: float = 1e-6, x32=None):
    """RMS norm scaled by ``1 + w``.  ``x32``: ``x`` before its last
    rounding, when the reference's compiled program reads that instead
    (see :func:`add_norm`)."""
    return _rms32(x.float() if x32 is None else x32, w, eps).to(x.dtype)


def add_norm(x, h, w, eps: float = 1e-6):
    """The residual sum ``x + h`` (in x.dtype) and its ``rms_norm``, which
    reads the sum before it is rounded, as the reference's compiled layers
    do: XLA computes an elementwise op whose result is only read converted
    to f32 in f32 (its convert moves ahead of the op)."""
    s32 = x.float() + h.float()
    return s32.to(x.dtype), _rms32(s32, w, eps).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


# (half, theta, device) -> f32 frequencies.  Built from numpy in f32, as the
# reference builds them, on first use; a captured step finds them here (a
# host-to-device copy cannot be captured).
_FREQS: dict = {}


def _freq(half: int, theta: float, device) -> torch.Tensor:
    key = (half, float(theta), torch.device(device))
    f = _FREQS.get(key)
    if f is None:
        f = torch.from_numpy(
            theta ** (-np.arange(0, half, dtype=np.float32) / half)).to(device)
        _FREQS[key] = f
    return f


def rope(x, positions, theta: float):
    """Rotary embedding. x: (B, T, n, K); positions: (B, T) or (T,)."""
    K = x.shape[-1]
    half = K // 2
    freq = _freq(half, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq                # (B, T, half)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA; global / sliding-local / bidirectional / cross)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Decode-time KV cache, written in place.

    Global layers: ``k``/``v`` are (B, N, S_max, K), absolute slots.
    Local layers:  (B, N, window, K) ring buffers (slot = position % W).
    ``pos`` is the number of tokens already cached: an int32 scalar tensor
    on the cache's device.
    """

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    window: int = 0  # 0 == global


def init_attention(gen, cfg: ModelConfig, device) -> dict:
    D, H, N, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = D ** -0.5
    p = {
        "wq": _init(gen, (D, H, K), s, _pdt(cfg), device),
        "wk": _init(gen, (D, N, K), s, _pdt(cfg), device),
        "wv": _init(gen, (D, N, K), s, _pdt(cfg), device),
        "wo": _init(gen, (H, K, D), (H * K) ** -0.5, _pdt(cfg), device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((K,), dtype=_pdt(cfg), device=device)
        p["k_norm"] = torch.zeros((K,), dtype=_pdt(cfg), device=device)
    return p


def _mask(kind: str, q_pos, k_pos, window: int):
    """Additive mask from absolute positions. q_pos (B,T), k_pos (B,S)."""
    ok = k_pos[:, None, :] >= 0
    if kind in ("global", "local"):
        ok = ok & (k_pos[:, None, :] <= q_pos[:, :, None])
    if kind == "local":
        ok = ok & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    return torch.where(ok, 0.0, -1e30)  # (B, T, S) f32


def _put(buf, idx, src):
    """``buf[:, :, idx] = src`` (src (B, N, len(idx), K)) in place, at
    device indices.  An f8 cache is written through its bytes, which every
    device's ``index_copy_`` takes."""
    src = src.to(buf.dtype)
    if buf.element_size() == 1 and buf.is_floating_point():
        buf, src = buf.view(torch.uint8), src.view(torch.uint8)
    buf.index_copy_(2, idx.long(), src)


def _heads(t):
    """(B, S, N, K) -> (B, N, S, K), the cache's layout (a view)."""
    return t.permute(0, 2, 1, 3)


def _write_cache(cache: KVCache, k, v, T: int):
    """Write this call's k/v (B, T, N, K) into ``cache`` and advance its
    ``pos`` by T, in place.  Returns the key positions for a decode step
    (None for a prefill, which attends over its own k/v)."""
    kh, vh = _heads(k), _heads(v)
    dev = k.device
    if T > 1:
        # one-shot prefill from an empty cache.  Local caches are RING
        # buffers (slot = position % W): the last W keys, rolled so that
        # position p sits in slot p % W
        if cache.window:
            W = cache.window
            if T >= W:
                shift = (T - W) % W
                cache.k.copy_(torch.roll(kh[:, :, -W:], shift, dims=2))
                cache.v.copy_(torch.roll(vh[:, :, -W:], shift, dims=2))
            else:
                cache.k[:, :, :T].copy_(kh)
                cache.v[:, :, :T].copy_(vh)
        else:
            # dynamic_update_slice: the start is clamped so the slice fits
            S = cache.k.shape[2]
            idx = (torch.clamp(cache.pos, 0, S - T)
                   + torch.arange(T, device=dev))
            _put(cache.k, idx, kh)
            _put(cache.v, idx, vh)
        cache.pos.add_(T)
        return None
    B = k.shape[0]
    if cache.window:  # ring buffer: write slot pos % W
        W = cache.window
        slot = torch.remainder(cache.pos, W).reshape(1)
        _put(cache.k, slot, kh)
        _put(cache.v, slot, vh)
        # slot i holds the latest position ≡ i (mod W) that is ≤ pos
        i = torch.arange(W, device=dev)[None, :]
        k_pos = (cache.pos - torch.remainder(cache.pos - i, W)).expand(B, W)
    else:
        S = cache.k.shape[2]
        idx = torch.clamp(cache.pos, 0, S - 1).reshape(1)
        _put(cache.k, idx, kh)
        _put(cache.v, idx, vh)
        k_pos = torch.arange(S, device=dev)[None, :].expand(B, S)
        k_pos = torch.where(k_pos < cache.pos + 1, k_pos, -1)
    cache.pos.add_(1)
    return k_pos


def attention(p, x, cfg: ModelConfig, kind: str, q_pos,
              cache: Optional[KVCache] = None,
              kv_x: Optional[torch.Tensor] = None,
              kv_pos: Optional[torch.Tensor] = None):
    """GQA attention.

    kind: 'global' (causal) | 'local' (causal sliding window) |
          'bidir' (encoder) | 'cross' (decoder→encoder, needs kv_x).
    q_pos: (B, T) absolute positions of the query tokens.
    cache: decode-time KV cache (self-attention kinds only); written in
           place and returned.
    """
    B, T, D = x.shape
    H, N, K = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // N

    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(x.dtype))
    src = x if kv_x is None else kv_x
    k = torch.einsum("bsd,dnk->bsnk", src, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dnk->bsnk", src, p["wv"].to(x.dtype))

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])

    if kind in ("global", "local"):
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, q_pos if kv_pos is None else kv_pos, cfg.rope_theta)

    if cache is not None:
        k_pos = _write_cache(cache, k, v, T)
        if k_pos is None:                      # prefill: its own k/v
            k_pos = q_pos if kv_pos is None else kv_pos
            kh, vh = _heads(k), _heads(v)
        else:                                  # decode: the whole cache
            kh, vh = cache.k, cache.v
    else:
        if kind == "cross":
            S = src.shape[1]
            k_pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
        else:
            k_pos = q_pos if kv_pos is None else kv_pos
        kh, vh = _heads(k), _heads(v)

    # (B, N, T*G, K): the query heads of one kv head side by side
    qh = q.reshape(B, T, N, G, K).permute(0, 2, 1, 3, 4).reshape(
        B, N, T * G, K)
    kh, vh = kh.to(x.dtype), vh.to(x.dtype)  # upcast quantized cache
    mask_kind = "bidir" if kind in ("cross", "bidir") else kind
    S = kh.shape[2]
    if S > _CHUNKED_KV_THRESHOLD and T > 1:
        out = _attn_chunked(qh, kh, vh, cfg, mask_kind, q_pos, k_pos, T, G)
    else:
        scores = torch.matmul(qh, kh.transpose(-1, -2)).float()
        scores = scores.reshape(B, N, T, G, S) * (K ** -0.5)
        if cfg.softcap_attn:
            c = cfg.softcap_attn
            scores = c * torch.tanh(scores / c)
        m = _mask(mask_kind, q_pos, k_pos, cfg.window)
        scores = scores + m[:, None, :, None, :]               # (B,N,T,G,S)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.matmul(w.reshape(B, N, T * G, S), vh)
    out = out.reshape(B, N, T, G, K).permute(0, 2, 1, 3, 4).reshape(
        B, T, H, K)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
    return out, cache


_CHUNKED_KV_THRESHOLD = 2048   # dense scores up to 2k keys; flash beyond
_KV_CHUNK = 1024


def _attn_chunked(qh, k, v, cfg: ModelConfig, mask_kind: str, q_pos, k_pos,
                  T: int, G: int, chunk: int = _KV_CHUNK):
    """Online-softmax attention over KV chunks, in f32 (the reference's
    ``lax.scan`` over key chunks, as a loop): never materializes the
    (T, S) score matrix.  qh (B, N, T*G, K); k, v (B, N, S, K)."""
    B, N, _, K = qh.shape
    S = k.shape[2]
    assert S % chunk == 0, (S, chunk)
    scale = K ** -0.5
    q32 = qh.float()
    m_prev = torch.full((B, N, T, G), -1e30, dtype=torch.float32,
                        device=qh.device)
    l_prev = torch.zeros((B, N, T, G), dtype=torch.float32, device=qh.device)
    acc = torch.zeros((B, N, T, G, K), dtype=torch.float32, device=qh.device)
    for c0 in range(0, S, chunk):
        kb = k[:, :, c0:c0 + chunk].float()
        vb = v[:, :, c0:c0 + chunk].float()
        s = (torch.matmul(q32, kb.transpose(-1, -2)).reshape(
            B, N, T, G, chunk) * scale)
        if cfg.softcap_attn:
            c = cfg.softcap_attn
            s = c * torch.tanh(s / c)
        mask = _mask(mask_kind, q_pos, k_pos[:, c0:c0 + chunk], cfg.window)
        s = s + mask[:, None, :, None, :]
        m_new = torch.maximum(m_prev, torch.amax(s, dim=-1))
        p_ = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_prev - m_new)
        l_prev = l_prev * corr + torch.sum(p_, dim=-1)
        acc = (acc * corr[..., None]
               + torch.matmul(p_.reshape(B, N, T * G, chunk), vb).reshape(
                   B, N, T, G, K))
        m_prev = m_new
    out = acc / torch.clamp(l_prev, min=1e-30)[..., None]
    return out.to(qh.dtype)                                   # (B,N,T,G,K)


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------

# The activations are written as the reference's lower, one operation at
# a time, each rounded to x.dtype, with their constants rounded to it
# first: in bf16, F.silu and F.gelu (which round once, at the end) differ
# from jax.nn.silu and jax.nn.gelu in a third of the elements.  In f32
# they agree with F.sigmoid, F.silu and F.gelu(approximate="tanh") to
# rounding.

def _const(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype`` (a weak-typed constant in the
    reference)."""
    return float(torch.tensor(c, dtype=torch.float64).to(dtype))


def sigmoid(x):
    """jax.nn.sigmoid: 1 / (1 + exp(-x))."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def silu(x):
    """jax.nn.silu: x * sigmoid(x)."""
    return x * sigmoid(x)


def gelu_tanh(x):
    """jax.nn.gelu's default, the tanh approximation:
    x * 0.5 * (1 + tanh(sqrt(2/π) * (x + 0.044715 x³)))."""
    inner = x + _const(0.044715, x.dtype) * ((x * x) * x)
    t = torch.tanh(_const(math.sqrt(2 / math.pi), x.dtype) * inner)
    return x * (0.5 * (1.0 + t))


_ACTS = {
    "silu": silu,
    "gelu": gelu_tanh,
    "relu_sq": lambda x: torch.square(F.relu(x)),
}


def init_mlp(gen, cfg: ModelConfig, device) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    p = {"wi": _init(gen, (D, F_), D ** -0.5, _pdt(cfg), device),
         "wo": _init(gen, (F_, D), F_ ** -0.5, _pdt(cfg), device)}
    if cfg.mlp_gated:
        p["wg"] = _init(gen, (D, F_), D ** -0.5, _pdt(cfg), device)
    return p


def mlp(p, x, cfg: ModelConfig):
    act = _ACTS[cfg.mlp_act]
    h = torch.matmul(x, p["wi"].to(x.dtype))
    if cfg.mlp_gated:
        g = torch.matmul(x, p["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    return torch.matmul(h, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-dropped, sort-based dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen, cfg: ModelConfig, device) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": _init(gen, (D, E), D ** -0.5, torch.float32, device),
        "wi": _init(gen, (E, D, F_), D ** -0.5, _pdt(cfg), device),
        "wg": _init(gen, (E, D, F_), D ** -0.5, _pdt(cfg), device),
        "wo": _init(gen, (E, F_, D), F_ ** -0.5, _pdt(cfg), device),
    }


_MOE_GROUPS = 32  # dispatch groups, as the reference's


def moe_capacity(cfg: ModelConfig, n_tokens: int):
    """(groups, tokens per group, capacity per expert) for ``n_tokens``
    tokens: dropless when a group holds at most 64 tokens."""
    G = math.gcd(_MOE_GROUPS, n_tokens)
    Ng = n_tokens // G
    if Ng <= 64:
        C = Ng * cfg.topk
    else:
        C = max(int(cfg.capacity_factor * Ng * cfg.topk / cfg.n_experts), 1)
    return G, Ng, C


def _dispatch(p, x, cfg: ModelConfig):
    """Route the tokens of ``x`` (B, T, D) and fill the per-group expert
    buffers.  Returns ``(buf (G, E, C, D), meta, aux)``; ``meta`` holds
    what the combine needs (sorted order, token of each pick, slots, kept
    picks, gate weights)."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    N = B * T
    G, Ng, C = moe_capacity(cfg, N)
    xf = x.reshape(G, Ng, D)
    dev = x.device

    logits = torch.matmul(xf.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, sel = torch.topk(probs, K, dim=-1)                   # (G, Ng, K)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # aux load-balance loss (Switch): E * Σ_e f_e · P_e (global)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).scatter_add_(
        0, sel.reshape(-1), torch.ones((N * K,), dtype=torch.float32,
                                       device=dev)) / (N * K)
    aux = E * torch.sum(me * ce)

    # one group per row: a stable sort by expert, each pick's position
    # among its expert's picks, and its slot (E*C: dropped)
    sel_f = sel.reshape(G, Ng * K)
    order = torch.argsort(sel_f, dim=-1, stable=True)
    sorted_e = torch.gather(sel_f, 1, order)
    token_of = order // K
    counts = torch.zeros((G, E), dtype=torch.int64, device=dev).scatter_add_(
        1, sel_f, torch.ones_like(sel_f))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(Ng * K, device=dev)[None, :]
                - torch.gather(starts, 1, sorted_e))
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    rows = torch.gather(xf, 1, token_of[..., None].expand(-1, -1, D))
    rows = rows * keep[..., None].to(x.dtype)
    # slot E*C is the sentinel row every dropped pick writes (zeros)
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=dev)
    buf.scatter_(1, slot[..., None].expand(-1, -1, D), rows)
    w = torch.gather(gate.reshape(G, Ng * K), 1, order).to(x.dtype)
    return (buf[:, :-1].reshape(G, E, C, D),
            (order, token_of, slot, keep, w, C), aux)


def moe_ffn(p, x, cfg: ModelConfig):
    """Grouped sort-based top-k MoE (GShard-style capacity drops, sorted
    dispatch), as the reference's: the same groups ``G = gcd(32, B*T)``,
    the same capacity (dropless at ≤ 64 tokens a group), a stable sort, so
    the same picks are dropped.  Returns (y, aux_loss).

    The combine sums each token's K weighted expert outputs in the order
    the reference's scatter-add applies them (ascending expert), one add
    at a time in ``x.dtype``: a gather and a sum, no atomic adds."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    buf, (order, token_of, slot, keep, w, C), aux = _dispatch(p, x, cfg)
    G, Ng = buf.shape[0], (B * T) // buf.shape[0]

    h = torch.einsum("gecd,edf->gecf", buf, p["wi"].to(x.dtype))
    g = torch.einsum("gecd,edf->gecf", buf, p["wg"].to(x.dtype))
    h = _ACTS[cfg.mlp_act](g) * h
    y = torch.einsum("gecf,efd->gecd", h, p["wo"].to(x.dtype))

    y_tok = y.reshape(G, E * C, D)
    picked = torch.gather(y_tok, 1, torch.clamp(slot, 0, E * C - 1)[
        ..., None].expand(-1, -1, D))
    picked = torch.where(keep[..., None], picked, 0.0) * w[..., None]
    # the sorted picks of each token, in sorted (ascending expert) order
    by_token = torch.argsort(token_of, dim=-1, stable=True)
    c = torch.gather(picked, 1, by_token[..., None].expand(-1, -1, D))
    c = c.reshape(G, Ng, K, D)
    out = c[:, :, 0]
    for j in range(1, K):
        out = out + c[:, :, j]
    return out.reshape(B, T, D), aux
