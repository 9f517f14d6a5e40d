"""The one traffic generator: a ring of chunks made on the device from a seed.

A traffic mix is a JSON file under ``traffic/`` (see ``traffic/*.json``);
this module reads its ``activity`` and ``fields`` and makes ``ring_chunks``
distinct chunks of a keyed stream, each ``(n_keys, chunk_ticks)``, with one
``torch.Generator`` on the device and a few large calls.  The benchmark
cycles the ring, so the stream is as long as the window needs.

``activity`` decides which key-ticks hold an event (``valid``):

* ``keys_active``: the share of keys active in each chunk.  Exactly
  ``round(n_keys * keys_active)`` keys are drawn afresh for every chunk,
  so every seed carries the same amount of work.
* ``session_ticks``: an active key's events lie in one run of this many
  consecutive ticks at a uniform offset (``null``: the whole chunk).
* ``valid_in_session``: the chance that a tick of a session holds an event.

``fields`` gives each leaf of the input's value (a name for a dict value,
or ``""`` for a plain one) a distribution:

* ``{"kind": "lognormal", "mean": m, "sigma": s, "spike_p": p,
  "spike_x": x}``: ``exp(N(m, s))``, a share ``p`` of it multiplied by ``x``;
* ``{"kind": "categorical", "values": [...]}``: uniform over the values.

A key-tick with no event holds 0 in every field.  Values are float32.
"""
from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["make_ring", "chunk_keyticks"]


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _valid(act: dict, R: int, K: int, T: int, g, device) -> torch.Tensor:
    frac = float(act.get("keys_active", 1.0))
    sess = act.get("session_ticks")
    p_in = float(act.get("valid_in_session", 1.0))
    if frac >= 1.0:
        active = torch.ones((R, K), dtype=torch.bool, device=device)
    else:
        n_act = max(1, round(K * frac))
        order = torch.rand((R, K), generator=g, device=device).argsort(dim=1)
        active = torch.zeros((R, K), dtype=torch.bool, device=device)
        active.scatter_(1, order[:, :n_act], True)
    valid = active[:, :, None].expand(R, K, T)
    if sess is not None and int(sess) < T:
        L = int(sess)
        off = torch.randint(0, T - L + 1, (R, K, 1), generator=g,
                            device=device)
        t = torch.arange(T, device=device)
        valid = valid & (t >= off) & (t < off + L)
    if p_in < 1.0:
        valid = valid & (torch.rand((R, K, T), generator=g, device=device)
                         < p_in)
    return valid.contiguous()


def _field(spec: dict, R: int, K: int, T: int, g, device) -> torch.Tensor:
    kind = spec["kind"]
    if kind == "lognormal":
        x = torch.empty((R, K, T), dtype=torch.float32, device=device)
        x.log_normal_(float(spec["mean"]), float(spec["sigma"]), generator=g)
        p = float(spec.get("spike_p", 0.0))
        if p > 0.0:
            spike = torch.rand((R, K, T), generator=g, device=device) < p
            x = torch.where(spike, x * float(spec["spike_x"]), x)
        return x
    if kind == "categorical":
        vals = torch.as_tensor(spec["values"], dtype=torch.float32,
                               device=device)
        idx = torch.randint(0, len(vals), (R, K, T), generator=g,
                            device=device)
        return vals[idx]
    raise ValueError(f"unknown field kind {kind!r}")


def make_ring(traffic: dict, n_keys: int, chunk_ticks: int, seed: int,
              device) -> List[Dict[str, dict]]:
    """``traffic["ring_chunks"]`` chunks, each ``{input: {"value": leaf or
    {name: leaf}, "valid": bool}}`` with leaves ``(n_keys, chunk_ticks)``,
    made on ``device`` from ``seed`` (the same seed gives the same ring on
    the same device)."""
    R, K, T = int(traffic["ring_chunks"]), int(n_keys), int(chunk_ticks)
    g = _generator(seed, device)
    ring: List[Dict[str, dict]] = [{} for _ in range(R)]
    for name in sorted(traffic["fields"]):
        fields = traffic["fields"][name]
        valid = _valid(traffic.get("activity", {}), R, K, T, g, device)
        leaves = {}
        for leaf in sorted(fields):
            x = _field(fields[leaf], R, K, T, g, device)
            leaves[leaf] = torch.where(valid, x, torch.zeros((), device=device))
        for i in range(R):
            value = ({k: v[i] for k, v in leaves.items()}
                     if set(leaves) != {""} else leaves[""][i])
            ring[i][name] = {"value": value, "valid": valid[i]}
    return ring


def chunk_keyticks(n_keys: int, chunk_ticks: int) -> int:
    """Key-ticks in one chunk: every slot of every key's stream, whether
    it holds an event or not (counted from the geometry, not the data)."""
    return int(n_keys) * int(chunk_ticks)
