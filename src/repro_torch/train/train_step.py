"""The serve step functions (port of ``repro.train.train_step``, serving
half): ``make_serve_steps(model)`` → ``(prefill_fn, decode_fn)``.
``make_train_step`` belongs to the training slice.

On a CUDA device the decode step is one captured CUDA graph per
``(params, caches)`` pair, the counterpart of the reference's single
jitted decode dispatch: ``prefill_fn`` keeps one set of cache buffers per
``(batch, max_len)`` and resets them for every prefill, so every wave of
that shape decodes through the same graph.  A call copies its tokens, its
position (an int32 tensor on the device) and, for encdec, the encoder
output into the graph's static inputs and replays it; the caches are
written in place, and nothing is read on the host.  The first call of a
pair runs the step once eagerly over a scratch copy of the caches (it
fills every lazy cache, which a capture may not do) and captures it
(``engine.capture.record``); a capture that fails raises: there is no
eager path on the card.  On the CPU both functions run eagerly.
"""
from __future__ import annotations

import torch

from ..engine import capture
from ..models import layers as L
from ..models.model import Model

__all__ = ["make_serve_steps"]


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

    def __call__(self, params, caches, tokens, pos, *rest):
        if tokens.device.type != "cuda":
            return self.model.decode_step(params, caches, tokens, pos, *rest)
        key = (id(params), id(caches))
        ent = self.graphs.get(key)
        if ent is None:
            ent = self.graphs[key] = self._capture(params, caches, tokens,
                                                   pos, rest)
        _, _, static, captured = ent
        static[0].copy_(tokens)
        if torch.is_tensor(pos):
            static[1].copy_(pos)
        else:
            static[1].fill_(pos)
        for s, r in zip(static[2:], rest):
            s.copy_(r)
        return captured.replay(), caches

    def _capture(self, params, caches, tokens, pos, rest):
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
        captured = capture.record(
            lambda: step(params, caches, *static[:2], *static[2:])[0],
            self._pool)
        # the pair is held, so neither id is reused while the graph lives
        return params, caches, static, captured


class _Prefill:
    """``prefill_fn``: one set of cache buffers per (batch, max_len),
    reset and refilled by every prefill of that shape."""

    def __init__(self, model: Model):
        self.model = model
        self.caches: dict = {}

    def __call__(self, params, tokens, *frames, max_len=None):
        B, S = tokens.shape
        key = (B, max_len or S)
        caches = self.caches.get(key)
        if caches is None:
            caches = self.caches[key] = self.model.init_cache(*key)
        return self.model.prefill(params, tokens, *frames, max_len=max_len,
                                  caches=caches)


def make_serve_steps(model: Model):
    """Returns (prefill_fn, decode_fn) matching the model family's
    signatures: ``prefill_fn(params, tokens[, frames], max_len=None)`` and
    ``decode_fn(params, caches, tokens, pos[, enc_out])``."""
    return _Prefill(model), _Decode(model)
