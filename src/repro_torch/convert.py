"""Carry grid data and stream state between the reference package and the
port.

The data is what both packages must share (the counterpart of weights
carried across in a model port): :func:`to_grid` builds the port's
``SnapshotGrid`` on a device from a reference grid's arrays, copied through
numpy (a read-only view of a jax array never reaches ``torch``), and
:func:`to_numpy` brings a port grid back as numpy arrays.

The carried state of a chunked run — a runner's or a session's
``state()`` pytree: halo tails, sparse dirty tails, 1-tick ``prev``
snapshots and hold seeds, the stream clock, and revision-ring entries —
plays the part weights play: :func:`state_from_numpy` turns the
reference's (numpy arrays) into tensors the port's ``restore`` takes, and
:func:`state_to_numpy` turns the port's into numpy arrays the reference's
``restore`` takes, so a stream started in one package continues in the
other.  Both packages keep time on the last axis of every scalar-per-tick
leaf (all the apps' payloads), so the arrays carry over as they are.
Nothing here imports the reference package: callers pass its arrays.

The LM stack's weights carry over too: :func:`lm_params_from_numpy` turns
the reference's ``model.init(...)[0]`` pytree (numpy arrays) into the
port's parameter module, unstacking the scanned superblocks and encdec's
layer stacks, and :func:`lm_params_to_numpy` restacks a module, or a dict
of gradients by parameter name, into the reference's tree.
:func:`opt_state_from_numpy` and :func:`opt_state_to_numpy` do the same
for AdamW's ``{m, v, step}``, and :func:`lm_cache_to_numpy` gives the
port's caches back in the reference's layout, leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from .core.stream import SnapshotGrid
from .device import resolve

__all__ = ["to_grid", "to_numpy", "state_from_numpy", "state_to_numpy",
           "lm_params_from_numpy", "lm_params_to_numpy",
           "opt_state_from_numpy", "opt_state_to_numpy", "lm_cache_to_numpy"]


def to_grid(value, valid, t0: int, prec: int, device=None) -> SnapshotGrid:
    """Port ``SnapshotGrid`` from a value pytree of arrays and a validity
    array (numpy, or anything ``np.array`` copies), with dtypes kept, on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""
    dev = resolve(device)

    def put(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return SnapshotGrid(value=tree_map(put, value), valid=put(valid),
                        t0=int(t0), prec=int(prec))


def to_numpy(grid: SnapshotGrid):
    """``(value, valid, t0, prec)`` of a port grid, as numpy arrays."""
    value = tree_map(lambda x: x.detach().cpu().numpy(), grid.value)
    return value, grid.valid.detach().cpu().numpy(), grid.t0, grid.prec


def _is_array(x) -> bool:
    return isinstance(x, np.ndarray) or (
        hasattr(x, "__array__") and hasattr(x, "dtype")
        and not torch.is_tensor(x) and not isinstance(x, np.generic))


def state_from_numpy(tree, device=None):
    """A state pytree with every array (numpy, or anything ``np.array``
    copies, such as a jax array) copied into a tensor on ``device`` (CUDA
    unless ``"cpu"`` is asked for); Python scalars (``__t``, ``started``,
    ring-entry chunk numbers) and the tree's structure are kept."""
    dev = resolve(device)
    return tree_map(lambda x: (torch.from_numpy(np.array(x, copy=True))
                               .to(dev) if _is_array(x) else x), tree)


def state_to_numpy(tree):
    """A state pytree with every tensor copied out as a numpy array; other
    leaves are kept."""
    return tree_map(lambda x: (x.detach().cpu().numpy().copy()
                               if torch.is_tensor(x) else x), tree)


def _tensor(a, device) -> torch.Tensor:
    """A copy of array ``a`` as a tensor on ``device``, its dtype kept.  A
    bfloat16 array (``ml_dtypes``, as numpy sees a jax bf16 array) goes
    through its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _from_ref(cfg, named: dict, tree) -> None:
    """Copy each leaf of the reference-layout ``tree`` into the port's
    tensor of the same place (``named``: name -> tensor), in place."""
    from .models.model import ref_location
    for n, t in named.items():
        path, i = ref_location(cfg, n)
        a = _leaf(tree, path)
        src = _tensor(a if i is None else a[i], "cpu")
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(f"{n}: {tuple(src.shape)} {src.dtype} for "
                             f"{tuple(t.shape)} {t.dtype}")
        with torch.no_grad():
            t.copy_(src)


def _to_ref(cfg, named: dict) -> dict:
    """The port's tensors (``named``: name -> tensor) as the reference's
    tree of numpy arrays, stacked layers restacked; float leaves as float32
    (exact for bf16 and f8)."""
    from .models.model import ref_location
    flat: dict = {}
    for n, t in named.items():
        path, i = ref_location(cfg, n)
        t = t.detach()
        a = (t.float() if t.is_floating_point() else t).cpu().numpy().copy()
        flat.setdefault(path, {})[i] = a
    out: dict = {}
    for path, parts in flat.items():
        a = (parts[None] if None in parts
             else np.stack([parts[i] for i in sorted(parts)]))
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = a
    return out


def lm_params_to_numpy(cfg, params) -> dict:
    """The reference's parameter tree of ``cfg`` (nested dicts of numpy
    arrays, float leaves as float32) from the port's parameter module, or
    from a dict of tensors by parameter name (gradients, moments)."""
    named = (params if isinstance(params, dict)
             else dict(params.named_parameters()))
    return _to_ref(cfg, named)


def opt_state_to_numpy(cfg, state) -> dict:
    """AdamW's state ``{m, v, step}`` in the reference's layout."""
    return {"m": _to_ref(cfg, state["m"]), "v": _to_ref(cfg, state["v"]),
            "step": state["step"].detach().cpu().numpy().copy()}


def opt_state_from_numpy(cfg, state, into: dict) -> dict:
    """Write the reference's AdamW state ``{m, v, step}`` (numpy or jax
    arrays) into the port's state ``into`` (as
    ``optimizer.init_opt_state(params)`` makes it), in place; returns
    ``into``."""
    _from_ref(cfg, into["m"], state["m"])
    _from_ref(cfg, into["v"], state["v"])
    with torch.no_grad():
        into["step"].copy_(_tensor(state["step"], "cpu").reshape(()))
    return into


def lm_params_from_numpy(cfg, params, device=None):
    """The port's parameter module (``transformer.LM`` or
    ``encdec.EncDec``) from the reference's parameter pytree of ``cfg``
    (arrays that ``np.asarray`` reads: numpy or jax), on ``device`` (CUDA
    unless ``"cpu"`` is asked for).  The stacked ``scan`` superblocks and
    encdec's ``enc``/``dec`` stacks become one module per layer."""
    from .models import encdec, transformer
    dev = resolve(device)
    put = lambda a: _tensor(a, dev)
    top = {k: put(v) for k, v in params.items()
           if k not in ("scan", "enc", "dec") and not k.startswith("rest")}
    if cfg.family == "encdec":
        def layers(stack, n):
            return [_tree(stack, lambda a, i=i: put(np.asarray(a)[i]))
                    for i in range(n)]
        return encdec.EncDec(cfg, top, layers(params["enc"],
                                              cfg.n_enc_layers),
                             layers(params["dec"], cfg.n_layers))
    blocks = []
    for path in transformer.layer_paths(cfg):
        if path[0] == "scan":
            _, b, s = path
            blocks.append(_tree(params["scan"][b],
                                lambda a, s=s: put(np.asarray(a)[s])))
        else:
            blocks.append(_tree(params[path[0]], put))
    return transformer.LM(cfg, top, blocks)


def _state_numpy(st) -> dict:
    """One layer's cache as numpy, in the reference's layout: a
    ``KVCache`` as ``{"k", "v", "pos"}`` with (B, S, N, K) buffers; float
    leaves as float32 (exact for bf16 and f8)."""
    from .models.layers import KVCache

    def arr(t):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy(
        ).copy()

    if isinstance(st, KVCache):
        return {"k": arr(st.k.permute(0, 2, 1, 3)),
                "v": arr(st.v.permute(0, 2, 1, 3)), "pos": arr(st.pos)}
    return {k: arr(v) for k, v in st.items()}


def lm_cache_to_numpy(cfg, caches) -> dict:
    """The port's caches (one entry per layer) as nested dicts of numpy
    arrays in the reference's tree: ``scan``/``b{i}`` leaves stacked over
    the superblocks, ``rest{i}``, or encdec's stacked ``dec``."""
    from .models import transformer
    per_layer = [_state_numpy(st) for st in caches]

    def stack(layers):
        return {k: np.stack([l[k] for l in layers]) for k in layers[0]}

    if cfg.family == "encdec":
        return {"dec": stack(per_layer)}
    out: dict = {}
    scan: dict = {}
    for path, st in zip(transformer.layer_paths(cfg), per_layer):
        if path[0] == "scan":
            scan.setdefault(path[1], []).append(st)
        else:
            out[path[0]] = st
    if scan:
        out["scan"] = {b: stack(sts) for b, sts in scan.items()}
    return out
