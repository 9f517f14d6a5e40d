"""Unified model façade (port of ``repro.models.model``, serving half):
``build_model(cfg, device)`` → init / prefill / decode / cache functions for
every architecture family.

The reference's ``input_specs`` and ``cache_axes`` (dry-run and sharding
metadata) and ``train_loss`` belong to the slices that port
``launch/dryrun.py``, ``launch/sharding.py`` and training.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve
from . import encdec, transformer

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable          # (generator=None) -> params (an nn.Module)
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
        prefill = (lambda params, tokens, frames, max_len=None, caches=None:
                   encdec.prefill(params, cfg, tokens, frames, max_len,
                                  caches))
        decode = (lambda params, caches, tokens, pos, enc_out:
                  encdec.decode_step(params, cfg, caches, tokens, pos,
                                     enc_out))
    else:
        prefill = (lambda params, tokens, max_len=None, caches=None:
                   transformer.prefill(params, cfg, tokens, max_len, caches))
        decode = (lambda params, caches, tokens, pos:
                  transformer.decode_step(params, cfg, caches, tokens, pos))
    return Model(
        cfg=cfg, device=dev,
        init=functools.partial(_init, mod, cfg, dev),
        prefill=prefill, decode_step=decode,
        init_cache=lambda B, S_max: mod.init_cache(cfg, B, S_max, dev))
