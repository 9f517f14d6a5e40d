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
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .shardctx import (batch_axes, hint, is_sharded, linear, model_axis,
                       placements, replicated)

__all__ = [
    "Params", "dtype_of", "rms_norm", "add_norm", "layer_norm", "rope",
    "init_attention", "attention_axes", "attention", "init_mlp", "mlp_axes",
    "mlp", "init_moe", "moe_axes", "moe_ffn", "KVCache", "sigmoid", "silu",
    "gelu_tanh",
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


def attention_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_attention`'s parameters (the
    reference's axes tree; ``launch.sharding`` maps them onto a mesh)."""
    a = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
         "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
    if cfg.qk_norm:
        a["q_norm"] = (None,)
        a["k_norm"] = (None,)
    return a


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
    if is_sharded(buf):
        # on a mesh, whatever axis the cache is laid over: a decode write
        # selects its slot over the whole buffer; a prefill's rows fill
        # the head of an empty cache (its start is 0)
        S, T = buf.shape[2], src.shape[2]
        if T > 1:
            new = src if T == S else torch.cat([src, buf[:, :, T:]], dim=2)
        else:
            hit = torch.arange(S, device=buf.device) == idx
            new = torch.where(hit[None, None, :, None], src, buf)
        buf.copy_(new)
        return
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
            elif is_sharded(cache.k):
                _put(cache.k, None, kh)
                _put(cache.v, None, vh)
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


def _heads_proj(x, w):
    """x (B, T, D) times w (D, n, K): (B, T, n, K), formed flat as
    (B, T, n*K) by :func:`linear` (the same product on one device and on
    a mesh, so a 1-rank mesh keeps the bits; on a mesh the weight's heads
    lie over ``model`` only where they divide it, so n*K is split only
    where n is)."""
    D, n, K = w.shape
    return linear(x, w.flatten(1)).unflatten(-1, (n, K))


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

    q = _heads_proj(x, p["wq"].to(x.dtype))
    src = x if kv_x is None else kv_x
    k = _heads_proj(src, p["wk"].to(x.dtype))
    v = _heads_proj(src, p["wv"].to(x.dtype))

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

    kh, vh = kh.to(x.dtype), vh.to(x.dtype)  # upcast quantized cache
    mask_kind = "bidir" if kind in ("cross", "bidir") else kind
    core = functools.partial(_attend, cfg=cfg, mask_kind=mask_kind)
    if is_sharded(q):
        out = _attend_sharded(core, q, kh, vh, q_pos, k_pos)
    else:
        out = core(q, kh, vh, q_pos, k_pos)
    out = linear(out.flatten(2), p["wo"].to(x.dtype).flatten(0, 1))
    return out, cache


def _attend(q, kh, vh, q_pos, k_pos, cfg: ModelConfig, mask_kind: str):
    """Attention's core: q (B, T, H, K) over kh, vh (B, N, S, K), masked by
    the positions q_pos (B, T) and k_pos (B, S); (B, T, H, K) out."""
    B, T, H, K = q.shape
    N, S = kh.shape[1], kh.shape[2]
    G = H // N
    # (B, N, T*G, K): the query heads of one kv head side by side
    qh = q.reshape(B, T, N, G, K).permute(0, 2, 1, 3, 4).reshape(
        B, N, T * G, K)
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
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.matmul(w.reshape(B, N, T * G, S), vh)
    return out.reshape(B, N, T, G, K).permute(0, 2, 1, 3, 4).reshape(
        B, T, H, K)


def _attend_sharded(core, q, kh, vh, q_pos, k_pos):
    """:func:`_attend` over ``DTensor`` operands, run on each rank's shard
    (``local_map``): batch over the data-parallel axes and kv heads over
    ``model`` where they divide (else replicated), as GSPMD partitions
    the reference's attention; the key axis is whole on every rank."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    batch = batch_axes(mesh, q.shape[0])
    tp = model_axis(mesh, kh.shape[1])
    q_spec = placements((batch, None, tp, None), mesh)
    kv_spec = placements((batch, tp, None, None), mesh)
    pos_spec = placements((batch, None), mesh)
    return local_map(core, out_placements=q_spec,
                     in_placements=(q_spec, kv_spec, kv_spec, pos_spec,
                                    pos_spec),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, kh, vh, replicated(q_pos, mesh), replicated(k_pos, mesh))


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


def mlp_axes(cfg: ModelConfig) -> dict:
    a = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    if cfg.mlp_gated:
        a["wg"] = ("embed", "mlp")
    return a


def mlp(p, x, cfg: ModelConfig):
    act = _ACTS[cfg.mlp_act]
    h = linear(x, p["wi"].to(x.dtype))
    if cfg.mlp_gated:
        g = linear(x, p["wg"].to(x.dtype))
        h = act(g) * h
    else:
        h = act(h)
    return linear(h, p["wo"].to(x.dtype))


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


def moe_axes(cfg: ModelConfig) -> dict:
    return {"router": ("embed", None),
            "wi": ("expert", "embed", "mlp_moe"),
            "wg": ("expert", "embed", "mlp_moe"),
            "wo": ("expert", "mlp_moe", "embed")}


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


def _route(xf, router, cfg: ModelConfig, C: int):
    """Route each group's tokens xf (G, Ng, D) and fill its expert buffer.
    Returns ``(buf (G, E, C, D), meta, probs, sel)``: ``meta`` holds what
    the combine needs (sorted order, token of each pick, slots, kept
    picks, gate weights); ``probs`` (G, Ng, E) and the picks ``sel``
    (G, Ng, K) feed the load-balance loss.  Every step is within a
    group."""
    G, Ng, D = xf.shape
    E, K = cfg.n_experts, cfg.topk
    dev = xf.device
    logits = torch.matmul(xf.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate, sel = torch.topk(probs, K, dim=-1)                   # (G, Ng, K)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # one group per row: a stable sort by expert, each pick's position
    # among its expert's picks, and its slot (E*C: dropped)
    sel_f = sel.reshape(G, Ng * K)
    order = torch.argsort(sel_f, dim=-1, stable=True)
    sorted_e = torch.gather(sel_f, 1, order)
    token_of = order // K
    # histograms as one-hot sums: exact counts, as the scatter-adds were
    counts = torch.sum(F.one_hot(sel_f, E), dim=1)
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(Ng * K, device=dev)[None, :]
                - torch.gather(starts, 1, sorted_e))
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    rows = torch.gather(xf, 1, token_of[..., None].expand(-1, -1, D))
    rows = rows * keep[..., None].to(xf.dtype)
    # slot E*C is the sentinel row every dropped pick writes (zeros)
    buf = torch.zeros((G, E * C + 1, D), dtype=xf.dtype, device=dev)
    buf.scatter_(1, slot[..., None].expand(-1, -1, D), rows)
    w = torch.gather(gate.reshape(G, Ng * K), 1, order).to(xf.dtype)
    return (buf[:, :-1].reshape(G, E, C, D), (order, token_of, slot, keep, w),
            probs, sel)


def _dispatch(p, x, cfg: ModelConfig):
    """Route the tokens of ``x`` (B, T, D) and fill the per-group expert
    buffers.  Returns ``(buf (G, E, C, D), meta, aux)``; ``meta``: the
    route's, then the capacity ``C``."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    N = B * T
    G, Ng, C = moe_capacity(cfg, N)
    buf, meta, probs, sel = _route(x.reshape(G, Ng, D), p["router"], cfg, C)
    # aux load-balance loss (Switch): E * Σ_e f_e · P_e (global)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.sum(F.one_hot(sel.reshape(-1), E).float(), dim=0) / (N * K)
    return buf, (*meta, C), E * torch.sum(me * ce)


def _dispatch_sharded(p, x, cfg: ModelConfig):
    """:func:`_dispatch` over a ``DTensor`` ``x``: the groups are split
    over the data-parallel axes (``G`` is a multiple of every data degree
    the batch takes, so each rank's rows are whole groups) and each rank
    routes its own (``local_map``, as the reference vmaps per group under
    GSPMD); the loss's two global means are sums over the ranks."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    N = B * T
    G, Ng, C = moe_capacity(cfg, N)
    mesh = x.device_mesh
    batch = batch_axes(mesh, B)
    rows = placements((batch,), mesh)
    whole = placements((), mesh)
    part = [Partial() if r.is_shard() else r for r in rows]

    def local(xl, router):
        Bl = xl.shape[0]
        buf, meta, probs, sel = _route(
            xl.reshape(Bl * G // B, Ng, D), router, cfg, C)
        return (buf, *meta, torch.sum(probs, dim=(0, 1)),
                torch.sum(F.one_hot(sel.reshape(-1), E).float(), dim=0))

    # each rank's router gradient sums over its own groups only: partial
    buf, *meta, psum, cnt = local_map(
        local, out_placements=(rows,) * 6 + (part, part),
        in_placements=(rows, whole), in_grad_placements=(rows, part),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"])
    aux = E * torch.sum((psum / N) * (cnt / (N * K)))
    return buf, (*meta, C), aux


def _experts(buf, wi, wg, wo, act):
    """The experts' gated MLP over their buffers (G, E, C, D)."""
    h = torch.einsum("gecd,edf->gecf", buf, wi)
    g = torch.einsum("gecd,edf->gecf", buf, wg)
    return torch.einsum("gecf,efd->gecd", act(g) * h, wo)


def _experts_sharded(experts, buf, w):
    """:func:`_experts` on a mesh, as GShard lays it out: each rank runs
    its groups (over the data axes) through its experts (over ``model``
    where they divide it), the weights gathered over their FSDP axis; a
    weight's gradient is each rank's sum over its own groups, partial
    over the data axes (``local_map``)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = buf.device_mesh
    ep = model_axis(mesh, buf.shape[1])
    batch = batch_axes(mesh, buf.shape[0])
    bufs = placements((batch, ep), mesh)
    ws = placements((ep,), mesh)
    dp = placements((batch,), mesh)
    wgrad = [Partial() if d.is_shard() else p for d, p in zip(dp, ws)]
    return local_map(experts, out_placements=bufs,
                     in_placements=(bufs, ws, ws, ws),
                     in_grad_placements=(bufs, wgrad, wgrad, wgrad),
                     device_mesh=mesh, redistribute_inputs=True)(buf, *w)


def _combine(y, token_of, slot, keep, w, K: int):
    """Each token's K weighted expert outputs from y (G, E, C, D), summed
    in the order the reference's scatter-add applies them (ascending
    expert), one add at a time in y's dtype: (G, Ng, D)."""
    G, E, C, D = y.shape
    y_tok = y.reshape(G, E * C, D)
    picked = torch.gather(y_tok, 1, torch.clamp(slot, 0, E * C - 1)[
        ..., None].expand(-1, -1, D))
    picked = torch.where(keep[..., None], picked, 0.0) * w[..., None]
    # the sorted picks of each token, in sorted (ascending expert) order
    by_token = torch.argsort(token_of, dim=-1, stable=True)
    c = torch.gather(picked, 1, by_token[..., None].expand(-1, -1, D))
    c = c.reshape(G, -1, K, D)
    out = c[:, :, 0]
    for j in range(1, K):
        out = out + c[:, :, j]
    return out


def moe_ffn(p, x, cfg: ModelConfig):
    """Grouped sort-based top-k MoE (GShard-style capacity drops, sorted
    dispatch), as the reference's: the same groups ``G = gcd(32, B*T)``,
    the same capacity (dropless at ≤ 64 tokens a group), a stable sort, so
    the same picks are dropped.  Returns (y, aux_loss).

    The combine sums each token's K weighted expert outputs in the order
    the reference's scatter-add applies them (ascending expert), one add
    at a time in ``x.dtype``: a gather and a sum, no atomic adds.  On a
    mesh, routing and combine run on each rank's groups and the expert
    buffers are laid out (dp over G, model over E): the all-to-all."""
    B, T, D = x.shape
    K = cfg.topk
    sharded = is_sharded(x)
    buf, meta, aux = (_dispatch_sharded if sharded else _dispatch)(p, x, cfg)
    buf = hint(buf, "dp", "model", None, None)
    w = [p[k].to(x.dtype) for k in ("wi", "wg", "wo")]
    experts = functools.partial(_experts, act=_ACTS[cfg.mlp_act])
    if sharded:
        y = _experts_sharded(experts, buf, w)
    else:
        y = experts(buf, *w)
    y = hint(y, "dp", "model", None, None)
    if not sharded:
        return _combine(y, *meta[1:5], K).reshape(B, T, D), aux
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    rows = placements((batch_axes(mesh, B),), mesh)
    out = local_map(lambda *a: _combine(*a, K), out_placements=rows,
                    in_placements=(rows,) * 5, device_mesh=mesh,
                    redistribute_inputs=True)(y, *meta[1:5])
    return out.reshape(B, T, D), aux
