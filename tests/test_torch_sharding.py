"""The port's sharding metadata and rules (``repro_torch.launch.sharding``,
``Model.param_axes`` / ``input_specs`` / ``cache_axes``) against the
reference's, for all ten *full* configurations, on the CPU.

The reference's axes tree comes from ``jax.eval_shape`` of its ``init``
with the dry-run's box trick (``src/repro/launch/dryrun.py:55-61``), so
nothing is allocated; its meshes are ``jax.sharding.AbstractMesh`` objects
(no devices needed), the port's ``{axis: size}`` dicts of the same
shapes: (16, 16) ``("data", "model")``, (2, 16, 16) ``("pod", "data",
"model")`` and (2, 4).

The port keeps one module per layer where the reference stacks a
superblock's (or encdec's) layers along a leading ``"layers"`` axis, and
its KV buffers are (B, N, S, K) against the reference's (B, S, N, K): a
port leaf is held against the reference leaf at
``models.model.ref_location`` with the leading layer entry dropped, and
a KV cache leaf with its middle two entries swapped.  A spec entry is
compared as the tuple of mesh axes it names (``P("data")`` and
``P(("data",))`` are one sharding).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.configs.base import registry as ref_registry
from repro.launch import sharding as RSH
from repro.models.model import build_model as ref_build
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.launch import sharding as SH
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import shardctx, transformer
from repro_torch.models.model import ref_location

ARCHS = sorted(ref_registry())
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _norm(entry) -> tuple:
    """A spec entry as the tuple of mesh axes it names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _spec(spec) -> tuple:
    return tuple(_norm(e) for e in tuple(spec))


@functools.lru_cache(maxsize=None)
def _ref(arch: str):
    """The reference's model, cfg and axes tree (no allocation)."""
    cfg = ref_config(arch)
    model = ref_build(cfg)
    box = {}

    def shapes_only(rng):
        p, a = model.init(rng)
        box["axes"] = a
        return p

    jax.eval_shape(shapes_only, jax.random.PRNGKey(0))
    return model, cfg, box["axes"]


@functools.lru_cache(maxsize=None)
def _port(arch: str):
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    return model, cfg, model.param_axes(), dict(
        model.init().named_parameters())


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_axes_of(arch, name):
    """The reference's axes for the port's parameter ``name``, its
    leading layer entry dropped where the leaf is stacked."""
    _, rcfg, raxes = _ref(arch)
    path, i = ref_location(rcfg, name)
    ax = _at(raxes, path)
    if i is not None:
        assert ax[0] == "layers", (name, ax)
        ax = ax[1:]
    return ax


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_the_reference_tree(arch):
    """Leaf for leaf through ``ref_location``; each tuple as long as its
    parameter's ``ndim``; every reference leaf covered."""
    _, rcfg, raxes = _ref(arch)
    _, _, axes, params = _port(arch)
    assert axes.keys() == params.keys()
    seen = set()
    for name, ax in axes.items():
        assert len(ax) == params[name].dim(), (name, ax)
        assert ax == _ref_axes_of(arch, name), name
        seen.add(ref_location(rcfg, name)[0])
    leaves = jax.tree_util.tree_flatten_with_path(
        raxes, is_leaf=lambda x: isinstance(x, tuple))[0]
    assert seen == {tuple(k.key for k in p) for p, _ in leaves}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_axis_rules_and_param_specs_match(arch, mesh):
    rmesh, pmesh = _meshes(mesh)
    _, rcfg, _ = _ref(arch)
    _, pcfg, axes, _ = _port(arch)
    rrules = RSH.axis_rules(rcfg, rmesh)
    prules = SH.axis_rules(pcfg, pmesh)
    assert prules == rrules
    sh = SH.param_shardings(axes, pcfg, pmesh)
    for name, ax in axes.items():
        path, i = ref_location(rcfg, name)
        want = _spec(RSH.spec_for(_at(_ref(arch)[2], path), rrules))
        if i is not None:
            want = want[1:]
        got = _spec(SH.spec_for(ax, prules))
        assert got == want, (name, got, want)
        assert sh[name].spec == SH.spec_for(ax, prules)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_shardings_match(arch, mesh):
    """Every input of every shape (the batch-1 guard at long_500k), and
    the decode caches: batch over the data axes, kv heads over model, or
    the cache's time axis where kv heads cannot take it."""
    rmesh, pmesh = _meshes(mesh)
    rmodel, rcfg, _ = _ref(arch)
    pmodel, pcfg, _, _ = _port(arch)
    assert _spec(SH.batch_sharding(pmesh).spec) == _spec(
        RSH.batch_sharding(rmesh).spec)
    for sname, shape in SHAPES.items():
        rspecs = rmodel.input_specs(REF_SHAPES[sname])
        pspecs = pmodel.input_specs(shape)
        for k, v in pspecs.items():
            if k == "caches":
                continue
            got = _spec(SH.batch_sharding_for(pmesh, v).spec)
            want = _spec(RSH.batch_sharding_for(rmesh, rspecs[k]).spec)
            assert got == want, (sname, k, got, want)
        if shape.kind != "decode":
            continue
        S = shape.seq_len
        rsh = RSH.cache_shardings(rmodel.cache_axes(S), rspecs["caches"],
                                  rcfg, rmesh)
        psh = SH.cache_shardings(pmodel.cache_axes(S), pspecs["caches"],
                                 pcfg, pmesh)
        for li, path in enumerate(_cache_paths(pcfg)):
            _same_layer(psh[li], _at(rsh, _cache_key(path)),
                        stacked=path[0] in ("scan", "dec"),
                        what=(sname, li), spec=True)


def _cache_paths(cfg) -> list:
    """Where each port layer's cache sits in the reference's cache tree
    (the stacked index last, as ``layer_paths``)."""
    if cfg.family == "encdec":
        return [("dec", i) for i in range(cfg.n_layers)]
    return transformer.layer_paths(cfg)


def _cache_key(path) -> tuple:
    """The key path of a layer's (stacked) entry in the reference's
    cache tree."""
    if path[0] == "scan":
        return path[:-1]
    return path[:1]


def _same_layer(got, want, stacked, what, spec=False):
    """One layer's port entry (``KVCache`` or dict) against the
    reference's: specs, shapes or axis strings, the reference's leading
    layer entry dropped where stacked and its KV (S, N) swapped."""
    def one(g, w, kv):
        if spec:
            g, w = _spec(g.spec), _spec(w.spec)
        elif isinstance(w, str):
            g, w = tuple(g.split(",")), tuple(w.split(","))
        else:
            g, w = tuple(g.shape), tuple(w.shape)
        if stacked:
            w = w[1:]
        if kv and len(w) == 4:
            w = (w[0], w[2], w[1], w[3])
        assert g == w, (what, g, w)

    if isinstance(got, L.KVCache):
        assert got.window == want.window, what
        for f in ("k", "v", "pos"):
            one(getattr(got, f), getattr(want, f), kv=True)
    else:
        assert got.keys() == want.keys(), what
        for k in got:
            one(got[k], want[k], kv=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_cache_axes_match(arch):
    """Keys, shapes and dtypes of every shape kind's inputs (``meta``
    tensors against ``ShapeDtypeStruct``), the decode caches' shapes, and
    ``cache_axes``' names."""
    rmodel, rcfg, _ = _ref(arch)
    pmodel, pcfg, _, _ = _port(arch)
    for sname, shape in SHAPES.items():
        rspecs = rmodel.input_specs(REF_SHAPES[sname])
        pspecs = pmodel.input_specs(shape)
        assert pspecs.keys() == rspecs.keys(), sname
        for k, v in pspecs.items():
            if k == "caches":
                continue
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(rspecs[k].shape), (sname, k)
            assert str(v.dtype).split(".")[1] == np.dtype(
                rspecs[k].dtype).name, (sname, k, v.dtype, rspecs[k].dtype)
        if shape.kind != "decode":
            continue
        S = shape.seq_len
        raxes = rmodel.cache_axes(S)
        paxes = pmodel.cache_axes(S)
        assert len(paxes) == len(pspecs["caches"])
        for li, path in enumerate(_cache_paths(pcfg)):
            key = _cache_key(path)
            stacked = path[0] in ("scan", "dec")
            _same_layer(pspecs["caches"][li], _at(rspecs["caches"], key),
                        stacked, (sname, li))
            _same_layer(paxes[li], _at(raxes, key), stacked, (sname, li))


def test_placements_order_the_data_axes_as_jax():
    """A spec entry over ("pod", "data") shards one dimension on both,
    pod outermost: ``Shard(0)`` on each, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    axes = ("pod", "data", "model")
    assert shardctx.placements((("pod", "data"), None, "model"), axes) == [
        Shard(0), Shard(0), Shard(2)]
    assert shardctx.placements((), axes) == [Replicate()] * 3
    sh = SH.NamedSharding({"pod": 2, "data": 16, "model": 16},
                          (("pod", "data"), None))
    assert sh.placements == [Shard(0), Shard(0), Replicate()]


def test_hints_are_the_identity_off_a_mesh():
    """No mesh declared, or a plain tensor: ``hint`` returns its input
    (the single-card paths keep their bits and their captured graphs),
    and ``scope`` changes nothing."""
    x = torch.randn(4, 8, 16)
    assert shardctx.hint(x, "dp", None, "model") is x
    shardctx.set_mesh_axes(("data", "model"), object())
    try:
        assert shardctx.hint(x, "dp", None, "model") is x
    finally:
        shardctx.clear()
    with shardctx.scope():
        assert shardctx.linear(x, torch.ones(16, 2)).shape == (4, 8, 2)
