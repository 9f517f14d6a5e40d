"""Unified model façade (port of ``repro.models.model``):
``build_model(cfg, device)`` → init / loss / prefill / decode / cache
functions for every architecture family.

:func:`ref_location` says where a parameter of the port sits in the
reference's parameter tree, where the scanned superblocks and encdec's
layer stacks carry a leading layer axis: weight decay, checkpoints in the
reference's layout and the weight conversions read it.

The sharding metadata the dry-run and ``launch.sharding`` read:
``param_axes()`` (each parameter's logical axes, the reference's axes
tree by ``named_parameters`` name), ``input_specs(shape)`` (the inputs of
a step of that shape as ``meta`` tensors, the counterpart of
``jax.ShapeDtypeStruct``) and ``cache_axes(S_max)`` (the decode caches'
logical axes).  The loss, prefill and decode functions run under
:func:`repro_torch.models.shardctx.scope`, so parameters laid over a mesh
as ``DTensor`` objects meet the plain tensors the model makes as
replicated.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig, Shape
from ..device import resolve
from . import encdec, shardctx, transformer
from .layers import dtype_of

__all__ = ["Model", "build_model", "ref_location"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable          # (generator=None) -> params (an nn.Module)
    train_loss: Callable    # (params, batch) -> scalar
    prefill: Callable       # (params, tokens, [frames,] max_len=None, caches=None)
    decode_step: Callable   # (params, caches, tokens, pos[, enc_out])
    init_cache: Callable    # (B, S_max) -> caches
    param_axes: Callable    # () -> {parameter name: logical axes}
    input_specs: Callable   # Shape -> {input name: meta tensor (or caches)}
    cache_axes: Callable    # (S_max) -> caches of logical-axis strings

    def param_count(self, params) -> int:
        return sum(p.numel() for p in params.parameters())


def _init(mod, cfg: ModelConfig, device: torch.device,
          generator: Optional[torch.Generator] = None):
    """Parameters drawn from ``generator`` (a fresh one seeded 0 on the
    model's device when none is given; on ``meta``, shapes only)."""
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    return mod.init(generator, cfg, device)


def _scoped(fn):
    """``fn`` run under :func:`shardctx.scope`."""
    def call(*args, **kwargs):
        with shardctx.scope():
            return fn(*args, **kwargs)
    return call


def _input_specs(mod, cfg: ModelConfig, shape: Shape) -> dict:
    """The inputs of a step of ``shape`` as ``meta`` tensors with the
    reference's keys, shapes and dtypes (token ids int32, as the
    reference's, though the port's embedding reads them as int64); a
    decode shape's ``caches`` are the port's cache objects on ``meta``."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=meta)

    dt = dtype_of(cfg.dtype)
    out = {}
    if mod is encdec and shape.kind != "decode":
        out["frames"] = spec((B, cfg.enc_seq, cfg.d_model), dt)
    if shape.kind in ("train", "prefill"):
        out["tokens"] = spec((B, S), torch.int32)
        if shape.kind == "train":
            out["labels"] = spec((B, S), torch.int32)
        return out
    out["caches"] = mod.init_cache(cfg, B, S, meta)
    out["tokens"] = spec((B, 1), torch.int32)
    out["pos"] = spec((), torch.int32)
    if mod is encdec:
        out["enc_out"] = spec((B, cfg.enc_seq, cfg.d_model), dt)
    return out


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (CUDA unless ``"cpu"`` is asked
    for)."""
    dev = resolve(device)
    mod = encdec if cfg.family == "encdec" else transformer
    if mod is encdec:
        loss = lambda params, batch: encdec.train_loss(params, cfg, batch)
        prefill = (lambda params, tokens, frames, max_len=None, caches=None:
                   encdec.prefill(params, cfg, tokens, frames, max_len,
                                  caches))
        decode = (lambda params, caches, tokens, pos, enc_out:
                  encdec.decode_step(params, cfg, caches, tokens, pos,
                                     enc_out))
    else:
        loss = lambda params, batch: transformer.train_loss(params, cfg,
                                                            batch)
        prefill = (lambda params, tokens, max_len=None, caches=None:
                   transformer.prefill(params, cfg, tokens, max_len, caches))
        decode = (lambda params, caches, tokens, pos:
                  transformer.decode_step(params, cfg, caches, tokens, pos))
    return Model(
        cfg=cfg, device=dev,
        init=functools.partial(_init, mod, cfg, dev),
        train_loss=_scoped(loss), prefill=_scoped(prefill),
        decode_step=_scoped(decode),
        init_cache=lambda B, S_max: mod.init_cache(cfg, B, S_max, dev),
        param_axes=functools.partial(mod.param_axes, cfg),
        input_specs=functools.partial(_input_specs, mod, cfg),
        cache_axes=functools.partial(mod.cache_axes, cfg))


def ref_location(cfg: ModelConfig, name: str):
    """Where the port's parameter ``name`` (as ``named_parameters`` gives
    it) sits in the reference's parameter tree of ``cfg``: ``(path, i)``,
    the key path of the reference's leaf and the index along its leading
    layer axis, or ``None`` where the leaf is not stacked (``embed``,
    ``head``, ``ln_f``, ``ln_enc``, a remainder layer's ``rest{i}``)."""
    parts = name.split(".")
    if parts[0] in ("enc", "dec"):
        return (parts[0], *parts[2:]), int(parts[1])
    if parts[0] != "blocks":
        return tuple(parts), None
    path = transformer.layer_paths(cfg)[int(parts[1])]
    if path[0] == "scan":
        return ("scan", path[1], *parts[2:]), path[2]
    return (path[0], *parts[2:]), None
