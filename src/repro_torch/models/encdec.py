"""Whisper-style encoder-decoder backbone (port of
``repro.models.encdec``).

As in the reference, the conv/mel frontend is a stub: the caller supplies
precomputed audio-frame embeddings (B, enc_seq, D) and the encoder adds
sinusoidal positions.  The decoder is a causal self-attention (RoPE) +
cross-attention stack.  The reference's stacked ``enc``/``dec`` parameter
trees are lists of layer modules here; its stacked ``dec`` cache is a list
of per-layer ``KVCache`` written in place.  In training (gradients on,
``cfg.remat``) every encoder layer, and every decoder layer run without
caches, is recomputed in the backward pass, as the reference's
``jax.checkpoint`` of its scan bodies.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from .shardctx import hint, linear
from .transformer import (cross_entropy, embed_lookup, flat_axes, positions,
                          remat, reset_cache)

__all__ = ["EncDec", "init", "forward_encoder", "init_cache", "decode_step",
           "prefill", "train_loss", "param_axes", "cache_axes"]


def _init_enc_block(gen, cfg, device) -> dict:
    D = cfg.d_model
    return {"ln1": torch.zeros((D,), dtype=torch.float32, device=device),
            "ln2": torch.zeros((D,), dtype=torch.float32, device=device),
            "attn": L.init_attention(gen, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def _init_dec_block(gen, cfg, device) -> dict:
    D = cfg.d_model
    return {"ln1": torch.zeros((D,), dtype=torch.float32, device=device),
            "lnx": torch.zeros((D,), dtype=torch.float32, device=device),
            "ln2": torch.zeros((D,), dtype=torch.float32, device=device),
            "attn": L.init_attention(gen, cfg, device),
            "xattn": L.init_attention(gen, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def param_axes(cfg: ModelConfig) -> dict:
    """Each parameter's logical axes by its ``named_parameters`` name (the
    reference's tree, the stacks' leading ``"layers"`` dropped)."""
    enc = {"ln1": (None,), "ln2": (None,), "attn": L.attention_axes(cfg),
           "mlp": L.mlp_axes(cfg)}
    dec = {"ln1": (None,), "lnx": (None,), "ln2": (None,),
           "attn": L.attention_axes(cfg), "xattn": L.attention_axes(cfg),
           "mlp": L.mlp_axes(cfg)}
    return flat_axes({"embed": ("vocab", "embed"), "ln_f": (None,),
                      "ln_enc": (None,), "enc": [enc] * cfg.n_enc_layers,
                      "dec": [dec] * cfg.n_layers})


class EncDec(L.Params):
    """``embed`` (tied), ``ln_f``, ``ln_enc``, and the ``enc`` / ``dec``
    layer lists."""

    def __init__(self, cfg: ModelConfig, tree: dict, enc: List[dict],
                 dec: List[dict]):
        super().__init__(tree)
        self.cfg = cfg
        if len(enc) != cfg.n_enc_layers or len(dec) != cfg.n_layers:
            raise ValueError(f"{len(enc)}/{len(dec)} layers for "
                             f"{cfg.n_enc_layers}/{cfg.n_layers}")
        self.enc = nn.ModuleList(L.Params(b) for b in enc)
        self.dec = nn.ModuleList(L.Params(b) for b in dec)


def init(gen: torch.Generator, cfg: ModelConfig, device) -> EncDec:
    D, Vp = cfg.d_model, cfg.vocab_padded
    tree = {"embed": L._init(gen, (Vp, D), D ** -0.5,
                             L.dtype_of(cfg.param_dtype), device),
            "ln_f": torch.zeros((D,), dtype=torch.float32, device=device),
            "ln_enc": torch.zeros((D,), dtype=torch.float32, device=device)}
    enc = [_init_enc_block(gen, cfg, device) for _ in range(cfg.n_enc_layers)]
    dec = [_init_dec_block(gen, cfg, device) for _ in range(cfg.n_layers)]
    return EncDec(cfg, tree, enc, dec)


# (T, D, device) -> the f32 table: computed in f64 by numpy, as the
# reference does, then cast
_SINUSOIDS: dict = {}


def _sinusoid(T: int, D: int, device) -> torch.Tensor:
    key = (T, D, torch.device(device))
    s = _SINUSOIDS.get(key)
    if s is None:
        pos = np.arange(T)[:, None]
        i = np.arange(D // 2)[None, :]
        ang = pos / (10_000 ** (2 * i / D))
        s = torch.from_numpy(np.concatenate(
            [np.sin(ang), np.cos(ang)], -1).astype(np.float32)).to(device)
        _SINUSOIDS[key] = s
    return s


def forward_encoder(params, cfg: ModelConfig, frames):
    """frames: (B, S_audio, D) precomputed frame embeddings (frontend stub)."""
    B, S, D = frames.shape
    dt = L.dtype_of(cfg.dtype)
    x = frames.to(dt) + _sinusoid(S, D, frames.device).to(dt)
    pos = positions(B, S, None, frames.device)

    def body(x, ps):
        if cfg.seq_parallel:  # head-unshardable fallback
            x = hint(x, "dp", "model", None)
        h = L.rms_norm(x, ps["ln1"])
        h, _ = L.attention(ps["attn"], h, cfg, "bidir", pos)
        x, h = L.add_norm(x, h, ps["ln2"])
        return x + L.mlp(ps["mlp"], h, cfg)

    rematted = cfg.remat and torch.is_grad_enabled()
    for ps in params["enc"]:
        x = remat(body, x, ps) if rematted else body(x, ps)
    return L.rms_norm(x, params["ln_enc"])


def _decoder(params, cfg: ModelConfig, tokens, enc_out, caches=None,
             pos0=None, last: Optional[int] = None):
    """The decoder over ``tokens`` attending to ``enc_out``; ``last``
    unembeds only the last ``last`` positions.  Returns (logits, caches)."""
    B, T = tokens.shape
    pos = positions(B, T, pos0, tokens.device)
    x = embed_lookup(params["embed"], tokens, L.dtype_of(cfg.dtype))

    def body(x, ps, st, enc_out):
        if cfg.seq_parallel and x.shape[1] > 1:
            x = hint(x, "dp", "model", None)
        h = L.rms_norm(x, ps["ln1"])
        h, _ = L.attention(ps["attn"], h, cfg, "global", pos, cache=st)
        x, h = L.add_norm(x, h, ps["lnx"])
        h, _ = L.attention(ps["xattn"], h, cfg, "cross", pos, kv_x=enc_out)
        x, h = L.add_norm(x, h, ps["ln2"])
        return x + L.mlp(ps["mlp"], h, cfg)

    rematted = cfg.remat and caches is None and torch.is_grad_enabled()
    for li, ps in enumerate(params["dec"]):
        if rematted:
            x = remat(body, x, ps, None, enc_out)
        else:
            x = body(x, ps, caches[li] if caches is not None else None,
                     enc_out)
    if last is not None:
        x = x[:, -last:]
    x = L.rms_norm(x, params["ln_f"])
    logits = linear(x, params["embed"].T.to(x.dtype)).float()
    return hint(logits, "dp", None, "model"), caches


def train_loss(params, cfg: ModelConfig, batch, aux_weight: float = 0.0):
    """batch: frames (B,S_audio,D), tokens (B,S), labels (B,S)."""
    enc = forward_encoder(params, cfg, batch["frames"])
    logits, _ = _decoder(params, cfg, batch["tokens"], enc)
    return cross_entropy(logits, batch["labels"])


def init_cache(cfg: ModelConfig, B: int, S_max: int, device) -> list:
    N, K = cfg.n_kv_heads, cfg.hd
    dt = L.dtype_of(cfg.cache_dtype or cfg.dtype)
    return [L.KVCache(torch.zeros((B, N, S_max, K), dtype=dt, device=device),
                      torch.zeros((B, N, S_max, K), dtype=dt, device=device),
                      torch.zeros((), dtype=torch.int32, device=device), 0)
            for _ in range(cfg.n_layers)]


def cache_axes(cfg: ModelConfig, S_max: int) -> list:
    """:func:`init_cache`'s mirror in logical-axis strings (the reference's
    names over the port's (B, N, S, K) buffers)."""
    kv = "batch,kv_heads,time,none"
    return [L.KVCache(kv, kv, "scalar", 0) for _ in range(cfg.n_layers)]


def prefill(params, cfg: ModelConfig, tokens, frames, max_len: int = None,
            caches=None):
    """Encode ``frames``, then prefill the decoder over ``tokens`` with
    caches for ``max_len`` tokens (``caches`` given: reset and reused).
    Returns (last logits (B,1,V), caches, enc_out)."""
    enc = forward_encoder(params, cfg, frames)
    if caches is None:
        caches = init_cache(cfg, tokens.shape[0], max_len or tokens.shape[1],
                            tokens.device)
    else:
        reset_cache(caches)
    logits, caches = _decoder(params, cfg, tokens, enc, caches=caches,
                              last=1)
    return logits, caches, enc


def decode_step(params, cfg: ModelConfig, caches, tokens, pos, enc_out):
    return _decoder(params, cfg, tokens, enc_out, caches=caches, pos0=pos)
