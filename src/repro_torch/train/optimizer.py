"""AdamW (port of ``repro.train.optimizer``).

The update is explicit, as in the reference: ``m`` and ``v`` are f32
tensors beside each parameter, the step counter is an int32 tensor, and
the learning rate, the bias corrections and the clip scale are computed
on the device from it, so a step reads nothing on the host and can be
captured in a CUDA graph.  Parameters and moments are updated in place
(the counterpart of the reference's donated buffers).

Optimizer state: ``{"m": {name: f32}, "v": {name: f32}, "step": int32}``,
keyed by the parameter names ``params.named_parameters()`` gives.

Weight decay applies where the reference applies it: to a leaf of two or
more dimensions *in the reference's tree*.  The reference stacks the
layers of a scanned superblock and encdec's layer stacks along a leading
axis, so there a norm weight, a bias or an RG-LRU vector is decayed too;
``ln_f``, ``ln_enc`` and a remainder layer's (``rest{i}``) vectors are
not.  The port keeps one module per layer, so the mask is read from each
parameter's place in the reference's layout
(:func:`repro_torch.models.model.ref_location`), not from its own ``ndim``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from ..models.model import ref_location

__all__ = ["AdamWConfig", "schedule", "init_opt_state", "adamw_update",
           "decay_mask"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor): linear warmup, then
    a cosine down to ``min_lr_frac``; f32, on the step's device."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params) -> dict:
    """Zero moments (f32, one per parameter) and step 0."""
    m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for n, p in params.named_parameters()}
    dev = next(iter(m.values())).device
    return {"m": m, "v": {n: t.clone() for n, t in m.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def decay_mask(params) -> Dict[str, bool]:
    """Whether each parameter is decayed: two or more dimensions in the
    reference's tree (a stacked layer adds one)."""
    cfg = params.cfg
    return {n: p.dim() + (ref_location(cfg, n)[1] is not None) >= 2
            for n, p in params.named_parameters()}


def adamw_update(params, grads: Dict[str, torch.Tensor], state: dict,
                 cfg: AdamWConfig):
    """One AdamW step over ``params`` (a parameter module) with ``grads``
    (by parameter name), in place.  Returns ``(params, state, metrics)``
    with ``metrics = {"grad_norm", "lr"}`` (f32 tensors on the device)."""
    with torch.no_grad():
        state["step"].add_(1)
        step = state["step"]
        lr = schedule(cfg, step)
        t = step.float()
        bc1 = 1 - torch.pow(cfg.b1, t)
        bc2 = 1 - torch.pow(cfg.b2, t)
        named = dict(params.named_parameters())
        g32 = {n: grads[n].float() for n in named}
        gsq = sum(torch.sum(torch.square(g)) for g in g32.values())
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        decay = decay_mask(params)
        for n, p in named.items():
            g = g32[n] * scale
            m, v = state["m"][n], state["v"][n]
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if decay[n]:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
