"""Recurrent token-mix blocks: RG-LRU (Griffin/recurrentgemma) and RWKV-6
(port of ``repro.models.recurrent``).

Both are time recurrences.  The RG-LRU's diagonal linear recurrence runs
as a log-depth scan along T (the reference's ``associative_scan``, here a
doubling scan of whole-tensor steps); RWKV-6's matrix-state recurrence
runs token by token (a loop over T), or chunk-parallel when
``cfg.rwkv_chunk`` is set.  No kernel of the reference lies here: these
are plain tensor ops.

Decode-time state (returned fresh; the stack writes it into its cache
buffers in place):
* RG-LRU:  ``h`` (B, W) recurrent state + ``conv`` (B, cw-1, W) tail.
* RWKV-6:  ``S`` (B, H, K, K) matrix state + token-shift tails (B, D).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import _dt, _init, _pdt, gelu_tanh, sigmoid, silu
from .shardctx import (batch_axes, is_sharded, linear, model_axis,
                       placements, replicated)

__all__ = ["init_rglru_block", "rglru_axes", "rglru_block",
           "init_rglru_state", "init_rwkv_mix", "rwkv_mix_axes", "rwkv_mix",
           "init_rwkv_channel", "rwkv_channel_axes", "rwkv_channel",
           "init_rwkv_state"]

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness constant


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin):  conv1d → gated diagonal linear RNN
# ---------------------------------------------------------------------------

def init_rglru_block(gen, cfg: ModelConfig, device) -> dict:
    D = cfg.d_model
    W = cfg.lru_width or D
    cw = cfg.conv_width
    lo, hi = 0.9 ** (1 / _C_RGLRU), 0.999 ** (1 / _C_RGLRU)
    return {
        "wx": _init(gen, (D, W), D ** -0.5, _pdt(cfg), device),
        "wy": _init(gen, (D, W), D ** -0.5, _pdt(cfg), device),
        "conv_w": _init(gen, (cw, W), cw ** -0.5, _pdt(cfg), device),
        "conv_b": torch.zeros((W,), dtype=_pdt(cfg), device=device),
        "wa": _init(gen, (W, W), W ** -0.5, _pdt(cfg), device),
        "wi": _init(gen, (W, W), W ** -0.5, _pdt(cfg), device),
        # Λ so that a = σ(Λ)^c spreads over (0.9, 0.999) as in the paper
        "lam": lo + (hi - lo) * torch.rand((W,), generator=gen,
                                           device=device,
                                           dtype=torch.float32),
        "wo": _init(gen, (W, D), W ** -0.5, _pdt(cfg), device),
    }


def rglru_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_rglru_block`'s parameters."""
    return {"wx": ("embed", "lru"), "wy": ("embed", "lru"),
            "conv_w": (None, "lru"), "conv_b": ("lru",),
            "wa": ("lru_in", "lru"), "wi": ("lru_in", "lru"),
            "lam": ("lru",), "wo": ("lru", "embed")}


def _causal_conv(x, w, b, tail: Optional[torch.Tensor]):
    """Depthwise causal conv along time. x (B,T,W); w (cw,W); tail
    (B,cw-1,W).  Returns (out, out before its bias, new tail)."""
    cw = w.shape[0]
    T = x.shape[1]
    if tail is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    out = xp[:, 0:T] * w[0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + T] * w[i].to(x.dtype)
    return out + b.to(x.dtype), out, xp[:, -(cw - 1):]


def _conv_sharded(x, w, b, tail: Optional[torch.Tensor]):
    """:func:`_causal_conv` over ``DTensor`` operands, on each rank's rows
    and channels (``local_map``): batch over the data axes and channels
    over ``model`` where they divide it (the time axis whole, as the conv
    needs it); the kernel's and bias's gradients sum over this rank's
    rows, partial over the data axes.  DTensor's own padding strategy is
    not used: PyTorch 2.11's redistribution planner fails on it at the
    (16, 16) mesh."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    batch = batch_axes(mesh, x.shape[0])
    lru = model_axis(mesh, x.shape[2])
    seq = placements((batch, None, lru), mesh)
    kernel = placements((None, lru), mesh)
    bias = placements((lru,), mesh)
    rows = placements((batch,), mesh)
    kernel_grad, bias_grad = ([Partial() if d.is_shard() else p
                               for d, p in zip(rows, pl)]
                              for pl in (kernel, bias))
    ins, grads = [seq, kernel, bias], [seq, kernel_grad, bias_grad]
    if tail is None:
        conv, args = functools.partial(_causal_conv, tail=None), (x, w, b)
    else:
        ins, grads = ins + [seq], grads + [seq]
        conv, args = _causal_conv, (x, w, b, replicated(tail, mesh))
    return local_map(conv, out_placements=(seq, seq, seq),
                     in_placements=tuple(ins),
                     in_grad_placements=tuple(grads), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling:
    log2(T) whole-tensor steps of the reference's combine
    ``(l, r) -> (l_a r_a, l_b r_a + r_b)``."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_block(p, x, cfg: ModelConfig, state: Optional[dict] = None):
    """Griffin recurrent block.  Returns (y, new_state)."""
    B, T, D = x.shape
    u = linear(x, p["wx"].to(x.dtype))
    gate = gelu_tanh(linear(x, p["wy"].to(x.dtype)))

    tail = state["conv"] if state is not None else None
    conv = _conv_sharded if is_sharded(u) else _causal_conv
    u, acc, new_tail = conv(u, p["conv_w"], p["conv_b"], tail)
    # the input term reads the conv output's last add (the bias) unrounded,
    # as the compiled reference does (see layers.add_norm)
    u32 = acc.float() + p["conv_b"].to(x.dtype).float()

    r = sigmoid(linear(u, p["wa"].to(u.dtype)).float())
    i = sigmoid(linear(u, p["wi"].to(u.dtype)).float())
    log_lam = torch.log(torch.clamp(p["lam"], 1e-6, 1 - 1e-6))
    log_a = _C_RGLRU * r * log_lam[None, None, :]            # (B,T,W) ≤ 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1
    mult = torch.sqrt(-torch.expm1(2.0 * log_a))
    b = mult * i * u32

    if T == 1 and state is not None:
        h = a[:, 0] * state["h"] + b[:, 0]
        hs = h[:, None, :]
        new_h = h
    else:
        if state is not None:  # inject carried state via the first step
            b = torch.cat([b[:, :1] + (a[:, 0] * state["h"])[:, None],
                           b[:, 1:]], dim=1)
        hs = _linear_scan(a, b)
        new_h = hs[:, -1]

    y = hs.to(x.dtype) * gate
    out = linear(y, p["wo"].to(x.dtype))
    return out, {"h": new_h, "conv": new_tail}


def init_rglru_state(cfg: ModelConfig, batch: int, device) -> dict:
    W = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, W),
                                dtype=_dt(cfg), device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 token mix (Finch): matrix state, data-dependent per-channel decay
# ---------------------------------------------------------------------------

def init_rwkv_mix(gen, cfg: ModelConfig, device) -> dict:
    D, H, K = cfg.d_model, cfg.n_heads, cfg.hd
    assert H * K == D, "rwkv6 head_dim * heads must equal d_model"
    lora = 64
    half = lambda: torch.full((D,), 0.5, dtype=_pdt(cfg), device=device)
    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "wr": _init(gen, (D, D), D ** -0.5, _pdt(cfg), device),
        "wk": _init(gen, (D, D), D ** -0.5, _pdt(cfg), device),
        "wv": _init(gen, (D, D), D ** -0.5, _pdt(cfg), device),
        "wg": _init(gen, (D, D), D ** -0.5, _pdt(cfg), device),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": _init(gen, (D,), 0.5, torch.float32, device) - 5.0,
        "wA": _init(gen, (D, lora), D ** -0.5, _pdt(cfg), device),
        "wB": _init(gen, (lora, D), lora ** -0.5, _pdt(cfg), device),
        "u": _init(gen, (H, K), 0.5, torch.float32, device),
        "ln_w": torch.ones((D,), dtype=_pdt(cfg), device=device),
        "wo": _init(gen, (D, D), D ** -0.5, _pdt(cfg), device),
    }


def rwkv_mix_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_rwkv_mix`'s parameters, by the
    reference's rule: a (D, D) matrix is ``("embed", "heads_rw")``, the
    output projection ``("heads_rw", "embed")``, anything else replicated
    (a shape test, so at D = 64 the LoRA factors count as (D, D) too)."""
    D, H, K, lora = cfg.d_model, cfg.n_heads, cfg.hd, 64
    shapes = {"mu_r": (D,), "mu_k": (D,), "mu_v": (D,), "mu_w": (D,),
              "mu_g": (D,), "wr": (D, D), "wk": (D, D), "wv": (D, D),
              "wg": (D, D), "w0": (D,), "wA": (D, lora), "wB": (lora, D),
              "u": (H, K), "ln_w": (D,), "wo": (D, D)}
    a = {k: (("embed", "heads_rw") if s == (D, D) else (None,) * len(s))
         for k, s in shapes.items()}
    a["wo"] = ("heads_rw", "embed")
    return a


def _rwkv_chunked(r, k, v, logw, S0, u, L: int):
    """Chunk-parallel RWKV-6 recurrence (GLA-style, stable form), a loop
    over L-token chunks carrying the (B,H,K,K) state:

        A[t,s] = Σ_c r[t,c]·k[s,c]·exp(LW[t−1,c] − LW[s,c])   (s < t)
        A[t,t] = r_t·(u ⊙ k_t)
        o      = A @ v
        S'     = exp(LW[L]) ⊙ S + Σ_s (k_s ⊙ exp(LW[L]−LW[s])) v_sᵀ

    Every exponent is a difference of cumulative log-decays over a suffix
    of the chunk, hence ≤ 0.  Returns (S_new, o (B,T,H,K))."""
    B, T, H, K = r.shape
    tri = torch.tril(torch.ones((L, L), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    S = S0
    outs = []
    for c0 in range(0, T, L):
        rb, kb, vb, wb = (z[:, c0:c0 + L] for z in (r, k, v, logw))
        lw = torch.cumsum(wb, dim=1)                         # LW_t inclusive
        lw_prev = lw - wb                                    # LW_{t-1}
        diff = lw_prev[:, :, None] - lw[:, None, :]          # (B,L,L,H,K)
        pair = (rb[:, :, None] * kb[:, None, :]) * torch.exp(
            torch.clamp(diff, max=0.0))
        A = torch.einsum("blmhk->bhlm", pair)                # sum over K
        A = A * tri[None, None]
        diag = torch.einsum("blhk,hk,blhk->blh", rb, u, kb)  # bonus term
        o = (torch.einsum("bhlm,bmhv->blhv", A, vb)
             + diag[..., None] * vb)
        o = o + torch.einsum("blhk,bhkv->blhv", rb * torch.exp(lw_prev), S)
        lwL = lw[:, -1:]                                     # (B,1,H,K)
        S = (torch.exp(lwL[:, 0])[..., None] * S
             + torch.einsum("blhk,blhv->bhkv",
                            kb * torch.exp(torch.clamp(lwL - lw, max=0.0)),
                            vb))
        outs.append(o)
    return S, torch.cat(outs, dim=1)


def _token_shift(x, mu, tail, f32_out: bool = False):
    """lerp(x_{t-1}, x_t, mu); tail is x_{-1} (B, D) from the prev chunk.
    ``f32_out``: the last add in f32, unrounded."""
    prev = torch.cat([tail[:, None, :].to(x.dtype), x[:, :-1]], dim=1)
    d = mu.to(x.dtype) * (x - prev)
    if f32_out:
        return prev.float() + d.float()
    return prev + d


def _recur_sharded(recur, r, k, v, w, S, u):
    """The RWKV-6 recurrence over ``DTensor`` operands, on each rank's
    rows and heads (``local_map``): batch over the data axes and heads
    over ``model`` where they divide it; the bonus ``u``'s gradient sums
    over this rank's rows, partial over the data axes."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = r.device_mesh
    batch = batch_axes(mesh, r.shape[0])
    heads = model_axis(mesh, r.shape[2])
    seq = placements((batch, None, heads), mesh)
    state = placements((batch, heads), mesh)
    bonus = placements((heads,), mesh)
    rows = placements((batch,), mesh)
    bonus_grad = [Partial() if d.is_shard() else p
                  for d, p in zip(rows, bonus)]
    return local_map(
        recur, out_placements=(state, seq),
        in_placements=(seq, seq, seq, seq, state, bonus),
        in_grad_placements=(seq, seq, seq, seq, state, bonus_grad),
        device_mesh=mesh, redistribute_inputs=True)(
        r, k, v, w, replicated(S, mesh), u)


def _rwkv_steps(r, k, v, w, S, u):
    """The token-by-token recurrence: o_t = r·(S + u⊙k v^T);
    S' = diag(w) S + k v^T.  Returns (S_new, o (B,T,H,K))."""
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]             # (B,H,K,K)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 S + u[None, :, :, None] * kv))
        S = wt[..., :, None] * S + kv
    return S, torch.stack(outs, dim=1)


def rwkv_mix(p, x, cfg: ModelConfig, state: Optional[dict] = None):
    """RWKV-6 time mix.  Returns (y, new_state).

    state = {"S": (B,H,K,K) f32, "x_tail": (B,D)}.
    """
    B, T, D = x.shape
    H, K = cfg.n_heads, cfg.hd
    tail = (state["x_tail"] if state is not None
            else torch.zeros((B, D), dtype=x.dtype, device=x.device))

    def proj(mu_key, w_key):
        xs = _token_shift(x, p[mu_key], tail)
        return linear(xs, p[w_key].to(x.dtype))

    r = proj("mu_r", "wr").reshape(B, T, H, K)
    k = proj("mu_k", "wk").reshape(B, T, H, K)
    v = proj("mu_v", "wv").reshape(B, T, H, K)
    g = silu(proj("mu_g", "wg"))

    # the decay reads its token shift's last add unrounded, as the
    # compiled reference does (see layers.add_norm)
    xw32 = _token_shift(x, p["mu_w"], tail, f32_out=True)
    ww = p["w0"].float() + linear(
        linear(xw32, p["wA"].float()), p["wB"].float())
    logw = -torch.exp(ww)                      # log decay ≤ 0, (B,T,D)
    w = torch.exp(logw).reshape(B, T, H, K)

    S0 = (state["S"] if state is not None
          else torch.zeros((B, H, K, K), dtype=torch.float32,
                           device=x.device))

    r32, k32, v32 = r.float(), k.float(), v.float()
    u = p["u"].float()
    logw = logw.reshape(B, T, H, K)

    L = cfg.rwkv_chunk
    if L and T >= 2 * L and T % L == 0:
        recur = functools.partial(_rwkv_chunked, L=L)
        args = (r32, k32, v32, logw, S0, u)
    else:
        recur, args = _rwkv_steps, (r32, k32, v32, w.float(), S0, u)
    if is_sharded(r32):
        S_new, o = _recur_sharded(recur, *args)
    else:
        S_new, o = recur(*args)

    # per-head group norm then gate
    o = o.reshape(B, T, H, K)
    o = o * torch.rsqrt(torch.mean(o * o, dim=-1, keepdim=True) + 1e-5)
    o = (o.reshape(B, T, D) * p["ln_w"].float()).to(x.dtype)
    o = o * g
    out = linear(o, p["wo"].to(x.dtype))
    return out, {"S": S_new, "x_tail": x[:, -1]}


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> dict:
    H, K = cfg.n_heads, cfg.hd
    return {"S": torch.zeros((batch, H, K, K), dtype=torch.float32,
                             device=device),
            "x_tail": torch.zeros((batch, cfg.d_model), dtype=_dt(cfg),
                                  device=device),
            "c_tail": torch.zeros((batch, cfg.d_model), dtype=_dt(cfg),
                                  device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 channel mix
# ---------------------------------------------------------------------------

def init_rwkv_channel(gen, cfg: ModelConfig, device) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((D,), 0.5, dtype=_pdt(cfg), device=device),
        "mu_r": torch.full((D,), 0.5, dtype=_pdt(cfg), device=device),
        "wk": _init(gen, (D, F_), D ** -0.5, _pdt(cfg), device),
        "wv": _init(gen, (F_, D), F_ ** -0.5, _pdt(cfg), device),
        "wr": _init(gen, (D, D), D ** -0.5, _pdt(cfg), device),
    }


def rwkv_channel_axes(cfg: ModelConfig) -> dict:
    return {"mu_k": (None,), "mu_r": (None,), "wk": ("embed", "mlp"),
            "wv": ("mlp", "embed"), "wr": ("embed", "heads_rw")}


def rwkv_channel(p, x, cfg: ModelConfig, state: Optional[dict] = None):
    B, T, D = x.shape
    tail = (state["c_tail"] if state is not None
            else torch.zeros((B, D), dtype=x.dtype, device=x.device))
    xk = _token_shift(x, p["mu_k"], tail)
    xr = _token_shift(x, p["mu_r"], tail)
    k = torch.square(F.relu(linear(xk, p["wk"].to(x.dtype))))
    kv = linear(k, p["wv"].to(x.dtype))
    r = sigmoid(linear(xr, p["wr"].to(x.dtype)))
    return r * kv, {"c_tail": x[:, -1]}
