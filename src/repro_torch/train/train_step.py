"""The train and serve step functions (port of ``repro.train.train_step``).

``make_train_step(model, opt_cfg, n_micro)`` → ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``: the loss and its
gradients (``torch.autograd.grad``; with ``n_micro > 1`` accumulated over
microbatches as the reference accumulates them: gradients in the
parameter dtype, the loss in f32, both divided by ``n_micro``), then
:func:`optimizer.adamw_update`, which writes the parameters and moments in
place.  ``metrics``: ``loss``, ``grad_norm`` and ``lr``, f32 tensors on the
device, never read on the host here.

On a CUDA device one steady train step is one captured CUDA graph
(forward, backward, clipping and the update), and a train step holds one
such graph: a call with another ``(params, opt_state, batch shapes)``
drops it (after a synchronize) and captures anew.  The first call for a
``(params, opt_state, batch shapes)`` runs the step eagerly on a side
stream (a real step: it fills every lazy cache, which a capture may not
do), then captures it into the graph's private memory pool, which also
holds the gradients and every temporary; a capture executes nothing.
Every later call copies its batch into the graph's static inputs
(``non_blocking``) and replays it.  A capture that fails raises: there is
no eager path on the card.  On the CPU every step runs eagerly.

``make_serve_steps(model)`` → ``(prefill_fn, decode_fn)``.  On a CUDA
device the decode step is one captured CUDA graph per ``(params, cache
set)``, the counterpart of the reference's single jitted decode dispatch:
``prefill_fn`` keeps one set of cache buffers per ``(batch, max_len)`` and
resets them for every prefill, so every wave of that shape decodes through
the same graph.  The caches a prefill returns carry the set's generation:
once a later prefill of the set has reset them, ``decode_fn`` refuses them
(a host-side integer compare).  A decode call copies its tokens, its
position (an int32 tensor on the device) and, for encdec, the encoder
output into the graph's static inputs, replays it and returns a copy of
its logits (the graph's own are rewritten by the next replay); the caches
are written in place, and nothing is read on the host.  The first call of
a pair runs the step once eagerly over a scratch copy of the caches and
captures it.  On the CPU both functions run eagerly.  Both run without
gradients, whether or not the parameters take them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..engine import capture
from ..models import layers as L
from ..models import shardctx
from ..models.model import Model
from .optimizer import AdamWConfig, adamw_update

__all__ = ["make_train_step", "make_serve_steps", "value_and_grad"]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def value_and_grad(model: Model, params, batch) -> tuple:
    """``(loss, grads)``: the train loss of ``batch`` and its gradient with
    respect to every parameter (by name, in the parameter's dtype; zero
    for a parameter the loss does not read).  Turns gradients on for
    ``params``."""
    params.requires_grad_(True)
    names, leaves = zip(*params.named_parameters())
    with torch.enable_grad(), shardctx.scope():
        loss = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def _micro_batches(batch: dict, n_micro: int) -> list:
    """``batch`` split into ``n_micro`` microbatches along its rows, as the
    reference's reshape splits it: the i-th holds rows ``i·B/n`` to
    ``(i+1)·B/n``.  A ``DTensor`` leaf (a batch laid over a mesh) is
    gathered whole over the ranks its rows are split across (one
    all-gather of the leaf a step), and each microbatch is laid out as
    the batch was."""
    parts = {}
    for k, x in batch.items():
        m = x.shape[0] // n_micro
        if shardctx.is_sharded(x):
            from torch.distributed.tensor import Replicate
            mesh, placements = x.device_mesh, x.placements
            whole = x.redistribute(mesh, [Replicate()] * mesh.ndim)
            parts[k] = [whole[i * m:(i + 1) * m].redistribute(mesh,
                                                               placements)
                        for i in range(n_micro)]
        else:
            parts[k] = x.reshape((n_micro, m) + x.shape[1:])
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


class _TrainStep:
    """``train_step``: eager on the CPU, a replayed graph on the card."""

    def __init__(self, model: Model, opt_cfg: AdamWConfig, n_micro: int):
        self.model, self.opt_cfg, self.n_micro = model, opt_cfg, n_micro
        self.graph: Optional[tuple] = None  # (key, params, opt_state,
        #                                     static batch, captured step)
        self.captures = 0

    def eager(self, params, opt_state, batch):
        """One step, eagerly: what a replay of the captured graph does."""
        if self.n_micro == 1:
            loss, grads = value_and_grad(self.model, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            grads = None
            for mb in _micro_batches(batch, self.n_micro):
                li, gi = value_and_grad(self.model, params, mb)
                loss = loss + li
                grads = gi if grads is None else {
                    k: grads[k] + g for k, g in gi.items()}
            loss = loss / self.n_micro
            grads = {k: g / self.n_micro for k, g in grads.items()}
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  self.opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    def __call__(self, params, opt_state, batch):
        dev = batch["tokens"].device
        if dev.type != "cuda":
            return self.eager(params, opt_state, batch)
        key = (id(params), id(opt_state["step"]),
               tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batch.items())))
        if self.graph is None or self.graph[0] != key:
            if self.graph is not None:
                # another state or batch shape: the old graph and its pool
                # go before the new step is captured
                torch.cuda.synchronize(dev)
                self.graph = None
            with capture.warm_up(dev):
                _, _, metrics = self.eager(params, opt_state, batch)
            static = {k: v.to(dev, copy=True) for k, v in batch.items()}
            captured = capture.record(
                lambda: self.eager(params, opt_state, static)[2],
                torch.cuda.graph_pool_handle())
            self.captures += 1
            # params and opt_state are held, so neither id is reused while
            # the graph lives
            self.graph = (key, params, opt_state, static, captured)
            return params, opt_state, metrics
        _, _, _, static, captured = self.graph
        for k, v in batch.items():
            static[k].copy_(v, non_blocking=True)
        metrics = captured.replay()
        return params, opt_state, {k: v.clone() for k, v in metrics.items()}


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                    n_micro: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, updating ``params`` and ``opt_state`` in place.

    ``batch`` leaves are (B, ...); with n_micro > 1 they are reshaped to
    (n_micro, B/n_micro, ...) and grad-accumulated.  ``train_step.eager``
    is the same step run eagerly on any device."""
    return _TrainStep(model, opt_cfg or AdamWConfig(), n_micro)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class _CacheSet:
    """One set of cache buffers of a (batch, max_len), and the number of
    prefills that have reset it."""

    def __init__(self, caches: list):
        self.caches = caches
        self.generation = 0


class Caches(list):
    """The caches a prefill hands out: the layers' entries of its cache
    set, valid until the next prefill of that set resets them."""

    def __init__(self, cache_set: _CacheSet):
        super().__init__(cache_set.caches)
        self.cache_set = cache_set
        self.generation = cache_set.generation

    def check(self) -> None:
        """Raises when a later prefill has reset these caches."""
        if self.generation != self.cache_set.generation:
            raise RuntimeError(
                f"stale caches: prefill {self.generation} of this (batch, "
                f"max_len) handed them out, and prefill "
                f"{self.cache_set.generation} has reset them since")


def _clone_caches(caches):
    out = []
    for st in caches:
        if isinstance(st, L.KVCache):
            out.append(L.KVCache(st.k.clone(), st.v.clone(), st.pos.clone(),
                                 st.window))
        else:
            out.append({k: v.clone() for k, v in st.items()})
    return out


class _Decode:
    """``decode_fn``: eager on the CPU, a replayed graph on the card."""

    def __init__(self, model: Model):
        self.model = model
        self.graphs: dict = {}
        self._pool = None

    @torch.no_grad()
    def __call__(self, params, caches, tokens, pos, *rest):
        if isinstance(caches, Caches):
            caches.check()
        if tokens.device.type != "cuda":
            return self.model.decode_step(params, caches, tokens, pos, *rest)
        owner = caches.cache_set if isinstance(caches, Caches) else caches
        key = (id(params), id(owner))
        ent = self.graphs.get(key)
        if ent is None:
            ent = self.graphs[key] = self._capture(params, caches, owner,
                                                   tokens, pos, rest)
        _, _, static, captured = ent
        static[0].copy_(tokens)
        if torch.is_tensor(pos):
            static[1].copy_(pos)
        else:
            static[1].fill_(pos)
        for s, r in zip(static[2:], rest):
            s.copy_(r)
        return captured.replay().clone(), caches

    def _capture(self, params, caches, owner, tokens, pos, rest):
        dev = tokens.device
        static = [tokens.clone(),
                  (pos.clone() if torch.is_tensor(pos) else
                   torch.full((), pos, dtype=torch.int32, device=dev))]
        static += [r.clone() for r in rest]
        step = self.model.decode_step
        scratch = _clone_caches(caches)
        with capture.warm_up(dev):
            step(params, scratch, *static[:2], *static[2:])
        del scratch
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        entries = list(caches)
        captured = capture.record(
            lambda: step(params, entries, *static[:2], *static[2:])[0],
            self._pool)
        # the pair is held, so neither id is reused while the graph lives
        return params, owner, static, captured


class _Prefill:
    """``prefill_fn``: one set of cache buffers per (batch, max_len),
    reset and refilled by every prefill of that shape."""

    def __init__(self, model: Model):
        self.model = model
        self.caches: Dict[tuple, _CacheSet] = {}

    @torch.no_grad()
    def __call__(self, params, tokens, *frames, max_len=None):
        B, S = tokens.shape
        key = (B, max_len or S)
        cs = self.caches.get(key)
        if cs is None:
            cs = self.caches[key] = _CacheSet(self.model.init_cache(*key))
        cs.generation += 1
        out = self.model.prefill(params, tokens, *frames, max_len=max_len,
                                 caches=cs.caches)
        return (out[0], Caches(cs), *out[2:])


def make_serve_steps(model: Model):
    """Returns (prefill_fn, decode_fn) matching the model family's
    signatures: ``prefill_fn(params, tokens[, frames], max_len=None)`` and
    ``decode_fn(params, caches, tokens, pos[, enc_out])``."""
    return _Prefill(model), _Decode(model)
