"""Decoder-only LM stack covering dense / MoE / Griffin / RWKV-6 families
(port of ``repro.models.transformer``).

The reference compiles the stack as a ``lax.scan`` over superblocks (one
pattern period each, parameters stacked) plus unrolled remainder layers.
The port runs its layers in a loop of :class:`Block` modules, one per
layer in order; :func:`_plan` stays, and :func:`layer_paths` says where
each layer's parameters sit in the reference's tree (``scan``/``b{i}`` at
superblock ``s``, or ``rest{i}``), so weights carry over
(:func:`repro_torch.convert.lm_params_from_numpy`).

Caches are a list with one entry per layer (a ``KVCache`` or a dict of
state tensors), written in place by :func:`forward`: a prefill resets and
fills them, a decode step writes one slot and advances each ``pos`` on the
device.

``remat``: in training (no caches, gradients on) each layer runs under
:func:`remat`, the counterpart of the reference's ``jax.checkpoint`` of its
scan body: its activations are recomputed in the backward pass.

Public surface (consumed by model.py / launch):
  init(gen, cfg, device)              -> LM module (the params)
  forward(params, cfg, tokens, ...)   -> (logits, caches, aux)
  init_cache(cfg, B, S_max, device)   -> caches
  prefill(params, cfg, tokens, max_len) -> (last logits, caches)
  decode_step(params, cfg, caches, tokens, pos) -> (logits, caches)
  train_loss(params, cfg, batch)      -> scalar
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ModelConfig
from . import layers as L
from . import recurrent as R
from .shardctx import (batch_axes, hint, is_sharded, linear, model_axis,
                       placements)

__all__ = ["Block", "LM", "init", "forward", "init_cache", "decode_step",
           "prefill", "layer_paths", "train_loss", "remat", "param_axes",
           "cache_axes", "flat_axes", "embed_lookup"]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _init_block(gen, cfg: ModelConfig, kind: str, device) -> dict:
    D = cfg.d_model
    p: dict = {"ln1": torch.zeros((D,), dtype=torch.float32, device=device),
               "ln2": torch.zeros((D,), dtype=torch.float32, device=device)}
    if kind in ("global", "local", "bidir"):
        p["attn"] = L.init_attention(gen, cfg, device)
    elif kind == "rec":
        p["rec"] = R.init_rglru_block(gen, cfg, device)
    elif kind == "rwkv":
        p["mix"] = R.init_rwkv_mix(gen, cfg, device)
    else:  # pragma: no cover
        raise KeyError(kind)

    if kind == "rwkv":
        p["chan"] = R.init_rwkv_channel(gen, cfg, device)
    elif cfg.is_moe:
        p["moe"] = L.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device)

    if cfg.softcap_attn:  # gemma2 sandwich norms
        p["ln1_post"] = torch.zeros((D,), dtype=torch.float32, device=device)
        p["ln2_post"] = torch.zeros((D,), dtype=torch.float32, device=device)
    return p


def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    """The logical axes of :func:`_init_block`'s parameters."""
    a: dict = {"ln1": (None,), "ln2": (None,)}
    if kind in ("global", "local", "bidir"):
        a["attn"] = L.attention_axes(cfg)
    elif kind == "rec":
        a["rec"] = R.rglru_axes(cfg)
    else:
        a["mix"] = R.rwkv_mix_axes(cfg)
    if kind == "rwkv":
        a["chan"] = R.rwkv_channel_axes(cfg)
    elif cfg.is_moe:
        a["moe"] = L.moe_axes(cfg)
    else:
        a["mlp"] = L.mlp_axes(cfg)
    if cfg.softcap_attn:
        a["ln1_post"] = (None,)
        a["ln2_post"] = (None,)
    return a


def _block(p, x, cfg: ModelConfig, kind: str, pos, state, x32=None):
    """One block. state: kind-specific decode state or None.  ``x32``:
    the input before its last rounding, which the first norm reads where
    the reference compiles this block together with what came before it.
    Returns (x, x before its last rounding, new_state, aux)."""
    aux = None
    if cfg.seq_parallel:
        # residual stream sharded over (dp, model-on-T): norms run local,
        # attention/MLP boundaries become all-gather / reduce-scatter pairs
        x = hint(x, "dp", "model", None)
        if x32 is not None:
            x32 = hint(x32, "dp", "model", None)
    h = L.rms_norm(x, p["ln1"], x32=x32)
    if kind in ("global", "local", "bidir"):
        h, new_state = L.attention(p["attn"], h, cfg, kind, pos, cache=state)
    elif kind == "rec":
        h, new_state = R.rglru_block(p["rec"], h, cfg, state)
    else:  # rwkv
        h, new_state = R.rwkv_mix(p["mix"], h, cfg, state)
    if cfg.softcap_attn:
        h = L.rms_norm(h, p["ln1_post"])
    x, h = L.add_norm(x, h, p["ln2"])
    if kind == "rwkv":
        h, cstate = R.rwkv_channel(p["chan"], h, cfg, state)
        if state is not None:
            new_state = {**new_state, **cstate}
    elif cfg.is_moe:
        h, aux = L.moe_ffn(p["moe"], h, cfg)
    else:
        h = L.mlp(p["mlp"], h, cfg)
    if cfg.softcap_attn:
        h = L.rms_norm(h, p["ln2_post"])
    out32 = x.float() + h.float()
    return out32.to(x.dtype), out32, new_state, aux


class Block(L.Params):
    """One layer: its parameters under the reference's names, and its
    kind (``global``, ``local``, ``rec`` or ``rwkv``)."""

    def __init__(self, cfg: ModelConfig, kind: str, tree: dict):
        super().__init__(tree)
        self.cfg, self.kind = cfg, kind

    def forward(self, x, pos, state=None, x32=None):
        return _block(self, x, self.cfg, self.kind, pos, state, x32)


class LM(L.Params):
    """The decoder-only stack: ``embed``, ``head`` (untied only),
    ``ln_f`` and ``blocks`` (one :class:`Block` per layer, in order)."""

    def __init__(self, cfg: ModelConfig, tree: dict, blocks: List[dict]):
        super().__init__(tree)
        self.cfg = cfg
        kinds = layer_kinds(cfg)
        if len(blocks) != len(kinds):
            raise ValueError(f"{len(blocks)} blocks for {len(kinds)} layers")
        self.blocks = nn.ModuleList(
            Block(cfg, kind, b) for kind, b in zip(kinds, blocks))


# ---------------------------------------------------------------------------
# stack planning: the reference's scan superblocks + unrolled remainder
# ---------------------------------------------------------------------------

def _plan(cfg: ModelConfig):
    P = len(cfg.pattern)
    n_sb = cfg.n_layers // P if cfg.scan_layers else 0
    if n_sb < 2:  # not worth scanning
        n_sb = 0
    rest = cfg.n_layers - n_sb * P
    rest_kinds = tuple(cfg.pattern[(n_sb * P + i) % P] for i in range(rest))
    return P, n_sb, rest_kinds


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The kind of every layer, in order."""
    return [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]


def layer_paths(cfg: ModelConfig) -> List[tuple]:
    """Where each layer (in order) sits in the reference's parameter and
    cache trees: ``("scan", f"b{i}", s)`` (superblock ``s`` of the stacked
    ``scan`` subtree) or ``(f"rest{i}",)``."""
    P, n_sb, rest_kinds = _plan(cfg)
    paths = [("scan", f"b{i}", s) for s in range(n_sb) for i in range(P)]
    return paths + [(f"rest{i}",) for i in range(len(rest_kinds))]


def _joined(cfg: ModelConfig):
    """Which layers the reference compiles together with what precedes
    them (the embedding, for the first): a layer after another of the same
    superblock, or a remainder layer after the embedding or another
    remainder layer; a superblock's first layer starts a ``scan``
    iteration, whose carry is rounded.  Also whether the final norm is
    joined to the last layer.  Where joined, a norm reads its input
    before the last rounding (:func:`repro_torch.models.layers.add_norm`).
    """
    paths = layer_paths(cfg)
    joined = []
    for li, path in enumerate(paths):
        if path[0] == "scan":
            joined.append(path[1] != "b0")
        else:
            joined.append(li == 0 or paths[li - 1][0] != "scan")
    return joined, paths[-1][0] != "scan"


def init(gen: torch.Generator, cfg: ModelConfig, device) -> LM:
    D, Vp = cfg.d_model, cfg.vocab_padded
    pdt = L.dtype_of(cfg.param_dtype)
    tree = {"embed": L._init(gen, (Vp, D), D ** -0.5, pdt, device)}
    if not cfg.tie_embeddings:
        tree["head"] = L._init(gen, (D, Vp), D ** -0.5, pdt, device)
    tree["ln_f"] = torch.zeros((D,), dtype=torch.float32, device=device)
    blocks = [_init_block(gen, cfg, kind, device)
              for kind in layer_kinds(cfg)]
    return LM(cfg, tree, blocks)


def flat_axes(tree, prefix: str = "") -> dict:
    """An axes tree (dicts and lists of tuple leaves) as ``{name: axes}``
    under the names ``named_parameters`` gives."""
    if isinstance(tree, tuple):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat_axes(v, f"{prefix}{k}."))
    return out


def param_axes(cfg: ModelConfig) -> dict:
    """Each parameter's logical axes, by its name in ``named_parameters``:
    the reference's axes tree, a stacked leaf's leading ``"layers"``
    dropped (the port keeps one module per layer)."""
    tree: dict = {"embed": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        tree["head"] = ("embed", "vocab")
    tree["ln_f"] = (None,)
    tree["blocks"] = [_block_axes(cfg, kind) for kind in layer_kinds(cfg)]
    return flat_axes(tree)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def embed_lookup(table, tokens, dtype):
    """Rows of ``table`` at ``tokens`` in ``dtype`` (``F.embedding``, a
    gather).  On a mesh the table is gathered whole first (ZeRO-3's
    gather of its FSDP axis, and of its vocab axis too), so the lookup
    runs on each rank's batch rows with no collective.  DTensor's own
    lookup into a vocab-sharded table is a masked partial sum, whose
    gradient it can neither add to the unembedding's (tied tables) nor
    build from a partial one (dbrx), and which it reorders against
    batch-sharded ids (its mask then misses the rows)."""
    if is_sharded(table):
        from torch.distributed.tensor import Replicate
        table = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
    return torch.nn.functional.embedding(tokens.long(), table).to(dtype)


def _embed(params, cfg: ModelConfig, tokens):
    """The embedded tokens, and the same before their last rounding."""
    dt = L.dtype_of(cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dt)
    if cfg.tie_embeddings:
        # the reference scales by sqrt(D) already rounded to the dtype
        x32 = hint(x.float() * L._const(cfg.d_model ** 0.5, dt), "dp",
                   None, None)
        return x32.to(dt), x32
    x = hint(x, "dp", None, None)
    return x, x.float()


def _unembed(params, cfg: ModelConfig, x, x32=None):
    x = L.rms_norm(x, params["ln_f"], x32=x32)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = hint(linear(x, w.to(x.dtype)).float(), "dp", None,
                  "model")
    if cfg.softcap_final:
        c = cfg.softcap_final
        logits = c * torch.tanh(logits / c)
    return logits


def _store(state, new_state) -> None:
    """Write a block's new recurrent state into its cache buffers (a
    ``KVCache`` was written in place by the attention itself)."""
    if isinstance(state, dict):
        for k, v in new_state.items():
            state[k].copy_(v)


def positions(B: int, T: int, pos0, device):
    """(B, T) int32 positions ``pos0 + t`` (``pos0``: None, an int or an
    int32 tensor on the device)."""
    ar = torch.arange(T, dtype=torch.int32, device=device)[None].expand(B, T)
    return ar if pos0 is None else pos0 + ar


def remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant).  The RNG state is not
    saved: the model draws no random numbers, and reading the RNG state is
    not allowed while a CUDA graph is being captured."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def forward(params, cfg: ModelConfig, tokens, caches=None, pos0=None,
            last: Optional[int] = None):
    """Full forward.  tokens (B, T).  caches/pos0 given → decode/prefill
    with state, the caches written in place.  ``last`` unembeds only the
    last ``last`` positions (rows are independent, so they equal those rows
    of the full logits).  Returns (logits, caches, aux)."""
    B, T = tokens.shape
    pos = positions(B, T, pos0, tokens.device)
    x, x32 = _embed(params, cfg, tokens)
    joined, joined_final = _joined(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    rematted = cfg.remat and caches is None and torch.is_grad_enabled()
    for li, blk in enumerate(params["blocks"]):
        st = caches[li] if caches is not None else None
        xin = x32 if joined[li] else None
        if rematted:
            x, x32, ns, aux = remat(blk, x, pos, None, xin)
        else:
            x, x32, ns, aux = blk(x, pos, st, xin)
        if aux is not None:
            aux_total = aux_total + aux
        if st is not None:
            _store(st, ns)
    if last is not None:
        x, x32 = x[:, -last:], x32[:, -last:]
    logits = _unembed(params, cfg, x, x32 if joined_final else None)
    return logits, caches, aux_total


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels):
    """Mean next-token cross-entropy over the labels ``>= 0``, as the
    reference computes it: ``logsumexp - gold`` in f32 (the gold logit
    picked with a gather: the reference's masked sum gives the same bits
    and a second (B, S, V) buffer).  On a mesh: :func:`_sharded_ce`."""
    if is_sharded(logits):
        logz, gold = _sharded_ce(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return (torch.sum((logz - gold) * mask)
            / torch.clamp(torch.sum(mask), min=1.0))


def _sharded_ce(logits, labels):
    """``(logsumexp, gold logit)`` of vocab-sharded ``logits`` without
    gathering them: each rank takes the logsumexp of its vocab shard and
    picks its gold logit with the reference's masked sum (zero where the
    label lies in another shard), on its own rows (``local_map``); the
    shards' logsumexps are combined by one more logsumexp over ranks and
    the gold picks by a sum."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    batch = batch_axes(mesh, logits.shape[0])
    vocab = model_axis(mesh, logits.shape[-1])
    rows = placements((batch,), mesh)

    def local(lg, lb):
        lo = (mesh.get_local_rank("model") * lg.shape[-1]) if vocab else 0
        iota = torch.arange(lo, lo + lg.shape[-1], device=lg.device)
        gold = torch.sum(torch.where(iota == lb[..., None], lg, 0.0), dim=-1)
        return torch.logsumexp(lg, dim=-1)[..., None], gold

    per_rank = [Shard(2) if n == "model" and vocab else p
                for n, p in zip(names, rows)]
    partial = [Partial() if n == "model" and vocab else p
               for n, p in zip(names, rows)]
    lse, gold = local_map(
        local, out_placements=(per_rank, partial),
        in_placements=(placements((batch, None, vocab), mesh), rows),
        device_mesh=mesh, redistribute_inputs=True)(logits, labels)
    return torch.logsumexp(lse, dim=-1), gold


def train_loss(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """Causal LM cross-entropy + MoE aux loss.  batch: tokens/labels
    (B,S)."""
    logits, _, aux = forward(params, cfg, batch["tokens"])
    return cross_entropy(logits, batch["labels"]) + aux_weight * aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _init_block_state(cfg: ModelConfig, kind: str, B: int, S_max: int,
                      device):
    N, K = cfg.n_kv_heads, cfg.hd
    dt = L.dtype_of(cfg.cache_dtype or cfg.dtype)
    if kind in ("global", "local"):
        W = min(cfg.window, S_max) if kind == "local" else S_max
        return L.KVCache(torch.zeros((B, N, W, K), dtype=dt, device=device),
                         torch.zeros((B, N, W, K), dtype=dt, device=device),
                         torch.zeros((), dtype=torch.int32, device=device),
                         W if kind == "local" else 0)
    if kind == "rec":
        return R.init_rglru_state(cfg, B, device)
    if kind == "rwkv":
        return R.init_rwkv_state(cfg, B, device)
    raise KeyError(kind)  # pragma: no cover


def init_cache(cfg: ModelConfig, B: int, S_max: int, device) -> list:
    return [_init_block_state(cfg, kind, B, S_max, device)
            for kind in layer_kinds(cfg)]


def _block_state_axes(cfg: ModelConfig, kind: str, S_max: int):
    """Logical axes of one layer's decode state, as comma-joined strings:
    the reference's, laid over the port's buffers.  A KV buffer is
    (B, N, S, K) here against the reference's (B, S, N, K): the names
    follow the dimensions."""
    if kind in ("global", "local"):
        kv = "batch,kv_heads,time,none"
        return L.KVCache(kv, kv, "scalar",
                         min(cfg.window, S_max) if kind == "local" else 0)
    if kind == "rec":
        return {"h": "batch,lru", "conv": "batch,none,lru"}
    if kind == "rwkv":
        return {"S": "batch,heads,none,none", "x_tail": "batch,none",
                "c_tail": "batch,none"}
    raise KeyError(kind)  # pragma: no cover


def cache_axes(cfg: ModelConfig, S_max: int) -> list:
    """A mirror of :func:`init_cache` carrying logical-axis strings, read
    by ``launch.sharding.cache_shardings``."""
    return [_block_state_axes(cfg, kind, S_max) for kind in layer_kinds(cfg)]


def reset_cache(caches) -> None:
    """Zero every buffer of ``caches`` in place (an empty cache)."""
    for st in caches:
        if isinstance(st, L.KVCache):
            st.k.zero_()
            st.v.zero_()
            st.pos.zero_()
        else:
            for t in st.values():
                t.zero_()


def decode_step(params, cfg: ModelConfig, caches, tokens, pos):
    """One decode step.  tokens (B, 1); pos: the context length so far (an
    int32 tensor on the device, or an int).  Returns (logits (B,1,V),
    caches)."""
    logits, caches, _ = forward(params, cfg, tokens, caches=caches,
                                pos0=pos)
    return logits, caches


def prefill(params, cfg: ModelConfig, tokens, max_len: int = None,
            caches=None):
    """Prefill: run the full prompt through the model building caches sized
    for ``max_len`` total tokens (prompt + decode budget).  ``caches``
    given (of that size) are reset and reused.  Returns the last
    position's logits (B, 1, V) and the caches."""
    B, S = tokens.shape
    if caches is None:
        caches = init_cache(cfg, B, max_len or S, tokens.device)
    else:
        reset_cache(caches)
    logits, caches, _ = forward(params, cfg, tokens, caches=caches,
                                pos0=None, last=1)
    return logits, caches
