"""Logical-axis → mesh-axis mapping (port of ``repro.launch.sharding``).

Model code names every parameter's dimensions with *logical* axes
(``Model.param_axes()``); this module maps them onto a mesh per
architecture, with the reference's divisibility-aware fallbacks:

* ``heads``/``kv_heads`` shard over ``model`` only when the head count
  divides the axis; otherwise they replicate and the MLP carries the
  tensor parallelism.
* ``vocab``/``mlp``/``expert`` shard over ``model`` (vocab is padded to
  a multiple of 128).
* ``embed`` (the d_model axis of weight matrices) shards over ``data``:
  ZeRO-3/FSDP, parameters and optimizer state live sharded.
* experts take ``model`` and free ``mlp_moe``; activations: batch over
  ``("pod", "data")``.

A sharding is a :class:`NamedSharding`: the mesh and a spec, one entry
per tensor dimension (a mesh axis, a tuple of them, or ``None``), as
``jax.sharding.NamedSharding`` holds a ``PartitionSpec``; its
``placements`` are the ``DTensor`` placements of that spec.  A mesh is a
``DeviceMesh`` or, where only its shape matters (the rules, the tests), a
dict ``{axis name: size}`` in mesh order.  :func:`place` lays a tensor
over the mesh (``distribute_tensor``: every rank passes the same global
tensor and keeps its shard); :func:`place_params`, :func:`place_opt_state`
and :func:`place_batch` do it for a model's parameters (in place), its
AdamW state and a batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..models import layers as L
from ..models.shardctx import placements

__all__ = ["NamedSharding", "mesh_shape", "tree_map_axes", "axis_rules",
           "spec_for", "param_shardings", "batch_sharding",
           "batch_sharding_for", "cache_shardings", "place", "place_params",
           "place_opt_state", "place_batch", "opt_shardings"]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (one entry per tensor dimension; missing trailing
    entries replicate)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.spec, mesh_shape(self.mesh))


def tree_map_axes(fn, tree):
    """Map over an axes tree where tuples are leaves."""
    if isinstance(tree, dict):
        return {k: tree_map_axes(fn, v) for k, v in tree.items()}
    return fn(tree)


def axis_rules(cfg: ModelConfig, mesh) -> Dict[str, Optional[str]]:
    """Logical axis name -> mesh axis (or None = replicate)."""
    shape = mesh_shape(mesh)
    tp = shape.get("model", 1)
    fsdp = "data" if "data" in shape else None

    def div(n):  # shard only when evenly divisible
        return "model" if n % tp == 0 else None

    W = cfg.lru_width or cfg.d_model
    rules = {
        "vocab": div(cfg.vocab_padded),
        "embed": fsdp,
        "mlp": div(cfg.d_ff),
        "mlp_moe": div(cfg.d_ff),
        "heads": div(cfg.n_heads),
        "kv_heads": div(cfg.n_kv_heads),
        "expert": div(cfg.n_experts) if cfg.n_experts else None,
        "lru": div(W),
        "lru_in": fsdp,
        "heads_rw": div(cfg.d_model),
        "layers": None,
    }
    # MoE: experts take the model axis; expert-internal mlp must not reuse it
    if cfg.n_experts and rules["expert"] == "model":
        rules["mlp_moe"] = None
        rules["embed_moe"] = fsdp
    return rules


def spec_for(axes: tuple, rules: Dict[str, Optional[str]]) -> tuple:
    """The spec of a leaf with logical ``axes`` (a mesh axis appears once
    per spec: a later dimension naming a used axis replicates)."""
    used = set()
    parts = []
    for ax in axes:
        m = rules.get(ax) if ax is not None else None
        if m in used:
            m = None
        if m is not None:
            used.add(m)
        parts.append(m)
    return tuple(parts)


def param_shardings(axes_tree, cfg: ModelConfig, mesh):
    rules = axis_rules(cfg, mesh)
    return tree_map_axes(
        lambda ax: NamedSharding(mesh, spec_for(ax, rules)), axes_tree)


def _dp(mesh) -> tuple:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def batch_sharding(mesh) -> NamedSharding:
    """Tokens/labels: batch over all DP axes."""
    return NamedSharding(mesh, (_dp(mesh),))


def batch_sharding_for(mesh, leaf) -> NamedSharding:
    """Batch sharding with a divisibility guard (global_batch=1 decode
    shapes replicate rather than over-shard)."""
    shape_ = mesh_shape(mesh)
    dp = _dp(mesh)
    deg = math.prod(shape_[a] for a in dp) if dp else 1
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape or shape[0] % deg != 0:
        # try the inner 'data' axis alone before full replication
        if shape and "data" in shape_ and shape[0] % shape_["data"] == 0:
            return NamedSharding(mesh, ("data",))
        return NamedSharding(mesh, ())
    return NamedSharding(mesh, (dp,))


def cache_shardings(axes_tree, struct_tree, cfg: ModelConfig, mesh):
    """Decode-state shardings from the model's ``cache_axes`` strings,
    over the port's caches (a list with one ``KVCache`` or dict per
    layer): ``batch`` over all DP axes; ``kv_heads``/``heads``/``lru``
    over ``model`` when divisible; and the context-parallel fallback:
    where kv heads cannot take ``model``, the cache's ``time`` axis
    does."""
    shape_ = mesh_shape(mesh)
    rules = dict(axis_rules(cfg, mesh))
    rules["batch"] = _dp(mesh) or None
    rules["time"] = "model" if rules.get("kv_heads") is None else None
    rules["none"] = None

    def degree(m):
        if m is None:
            return 1
        if isinstance(m, tuple):
            return math.prod(shape_[a] for a in m)
        return shape_[m]

    def one(ax_str: str, leaf) -> NamedSharding:
        # 'scalar' marks a rank-0 leaf: it contributes no spec entry
        names = [None if a in ("none", "") else a
                 for a in ax_str.split(",") if a != "scalar"]
        shape = tuple(getattr(leaf, "shape", ()))
        used = set()
        parts = []
        for d, ax in enumerate(names):
            m = rules.get(ax) if ax is not None else None
            dim = shape[d] if d < len(shape) else 0
            if isinstance(m, tuple):
                m = tuple(x for x in m if x not in used) or None
                if m is not None and dim % degree(m) != 0:
                    m = None  # e.g. batch=1 long-context decode
                if m is not None:
                    used.update(m)
            elif m is not None:
                if m in used or dim % degree(m) != 0:
                    m = None
                else:
                    used.add(m)
            parts.append(m)
        return NamedSharding(mesh, tuple(parts))

    def layer(ax, st):
        if isinstance(ax, L.KVCache):
            return L.KVCache(one(ax.k, st.k), one(ax.v, st.v),
                             one(ax.pos, st.pos), ax.window)
        return {k: one(a, st[k]) for k, a in ax.items()}

    return [layer(ax, st) for ax, st in zip(axes_tree, struct_tree)]


# ---------------------------------------------------------------------------
# laying tensors over a mesh
# ---------------------------------------------------------------------------

def place(t: torch.Tensor, sharding: NamedSharding):
    """``t`` (the same global tensor on every rank) as a ``DTensor`` laid
    out by ``sharding``; each rank keeps its shard, with no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def place_params(params, mesh, cfg: ModelConfig,
                 shardings: Optional[dict] = None) -> dict:
    """Turn every parameter of ``params`` (a model's parameter module)
    into a ``DTensor`` laid out by its logical axes' rules, in place
    (each ``nn.Parameter`` keeps its ``requires_grad``).  Returns the
    shardings, by parameter name."""
    from ..models.model import build_model
    if shardings is None:
        axes = build_model(cfg, device="meta").param_axes()
        shardings = param_shardings(axes, cfg, mesh)
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod._parameters[leaf] = torch.nn.Parameter(
            place(p.detach(), shardings[name]),
            requires_grad=p.requires_grad)
    return shardings


def opt_shardings(param_sh: dict, mesh) -> dict:
    """AdamW state's shardings: each moment as its parameter, the step
    replicated."""
    return {"m": dict(param_sh), "v": dict(param_sh),
            "step": NamedSharding(mesh, ())}


def place_opt_state(opt: dict, shardings: dict) -> dict:
    """AdamW state (``{"m", "v", "step"}``) laid out by ``shardings`` (as
    :func:`opt_shardings` gives them), in place of its tensors."""
    for k in ("m", "v"):
        for n, t in opt[k].items():
            opt[k][n] = place(t, shardings[k][n])
    opt["step"] = place(opt["step"], shardings["step"])
    return opt


def place_batch(batch: dict, mesh) -> dict:
    """A batch's leaves laid out by :func:`batch_sharding_for` (rank-0
    leaves replicated)."""
    return {k: place(v, batch_sharding_for(mesh, v) if v.dim() >= 1
                     else NamedSharding(mesh, ()))
            for k, v in batch.items()}
