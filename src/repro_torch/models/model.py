"""Unified model façade (port of ``repro.models.model``):
``build_model(cfg, device)`` → init / loss / prefill / decode / cache
functions for every architecture family.

:func:`ref_location` says where a parameter of the port sits in the
reference's parameter tree, where the scanned superblocks and encdec's
layer stacks carry a leading layer axis: weight decay, checkpoints in the
reference's layout and the weight conversions read it.

The reference's ``input_specs`` and ``cache_axes`` (dry-run and sharding
metadata) belong to the slice that ports ``launch/dryrun.py`` and
``launch/sharding.py``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve
from . import encdec, transformer

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

    def param_count(self, params) -> int:
        return sum(p.numel() for p in params.parameters())


def _init(mod, cfg: ModelConfig, device: torch.device,
          generator: Optional[torch.Generator] = None):
    """Parameters drawn from ``generator`` (a fresh one seeded 0 on the
    model's device when none is given)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return mod.init(generator, cfg, device)


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
        init=functools.partial(_init, mod, cfg, dev), train_loss=loss,
        prefill=prefill, decode_step=decode,
        init_cache=lambda B, S_max: mod.init_cache(cfg, B, S_max, dev))


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
