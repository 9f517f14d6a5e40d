"""The port's sharded LM training on 8 and 4 gloo ranks, on the CPU.

One module fixture runs, in order:

1. one JAX subprocess (the reference, one device): the weights of each
   case, a seeded batch, ``jax.jit(jax.value_and_grad(train_loss))`` and
   the jitted ``make_train_step`` with the same ``AdamWConfig``;
2. 8 plain ``python`` processes in one gloo group as a (2 data × 4 model)
   mesh: each loads those weights, runs the port's unsharded
   ``value_and_grad`` and train step, then the same on the mesh
   (parameters and AdamW state laid out by ``launch.sharding``, the batch
   by ``place_batch``, the hints on); saves a checkpoint of the sharded
   state and of the reference test's tree (``test_elastic_checkpoint_
   reshard``);
   then, at two microbatches (``n_micro`` 2), the same for granite-moe
   (whose per-microbatch capacity and load-balancing loss see which rows
   make a microbatch), against the reference's jitted step at
   ``n_micro`` 2; and one step of qwen3 and granite-moe at ``n_micro`` 2
   on the mesh, counted on rank 0 as it runs (:class:`RealCount` below;
   PyTorch's ``CommDebugMode`` cannot: its module tracker fails inside
   the remat's recomputation);
3. beside them, one process with a ``fake`` group of 8 ranks as the same
   (2, 4) mesh, where the dry-run (``launch.dryrun.trace_cell``) traces
   that step of each of those two over fake tensors: its per-device
   FLOPs, argument bytes and collectives (kind, bytes, group, count) must
   equal the real rank's count exactly;
4. 4 processes as a (4, 1) mesh: restore both checkpoints onto it
   (``shardings=``), and run ``launch.train.main`` at SMOKE for 6 steps,
   again cut at step 3 and relaunched.

The cases are the reference's own sharded-step test's qwen3 (4 layers,
``d_model`` 64, ``d_ff`` 128, 4/4 heads: ``tests/test_parallel_multidev
.py::test_dryrun_cell_small_mesh``, which cannot run under jax 0.9, C8),
granite-moe SMOKE, whisper SMOKE and recurrentgemma SMOKE, all at f32.  The reference's own
sharded step is no oracle; its unsharded jitted step is.

Bounds (f32; sums over shards reorder): the loss within 1e-5 relative and
every gradient leaf within 1e-4 of that leaf's largest magnitude, sharded
against the port's unsharded step and against the reference; an updated
parameter within 1e-6 of its leaf's largest magnitude plus what that
gradient bound ``G`` can move AdamW's first step ``lr·m̂/(√v̂ + eps)``,
which reads each gradient element twice (in ``m`` and in ``v``; on a mesh
the two may round apart): ``lr·2G/(|g| - G + eps)``, at most ``2·lr``
(its sign flips where ``|g| ≤ G``).  The
checkpoint restored onto 4 ranks, and ``launch.train`` cut and relaunched
on 4 ranks, are held bit for bit.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
CASES = ("qwen3-c8", "granite-moe-1b-a400m", "whisper-large-v3",
         "recurrentgemma-9b")
MICRO_CASES = ("granite-moe-1b-a400m",)
COUNT_CASES = ("qwen3-c8", "granite-moe-1b-a400m")
LR = 1e-3
F32_LOSS, F32_GRAD, F32_PARAM = 1e-5, 1e-4, 1e-6
BYTES_REL = 0.01   # the dry-run's bytes accessed against a real rank's
EPS = 1e-8   # AdamWConfig's

# the cases' configs and batch, the same text in both packages' processes
COMMON = r'''
import dataclasses
import numpy as np

B, S, LR, MICRO = 8, 16, 1e-3, 2
CASES = ("qwen3-c8", "granite-moe-1b-a400m", "whisper-large-v3",
         "recurrentgemma-9b")
MICRO_CASES = ("granite-moe-1b-a400m",)
COUNT_CASES = ("qwen3-c8", "granite-moe-1b-a400m")


def case_cfg(registry, name):
    f32 = dict(dtype="float32", param_dtype="float32")
    if name == "qwen3-c8":
        return dataclasses.replace(registry()["qwen3-1.7b"][1], n_layers=4,
                                   d_ff=128, d_model=64, n_heads=4,
                                   n_kv_heads=4, **f32)
    return dataclasses.replace(registry()[name][1], **f32)


def make_batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch
'''

REF = r'''
import sys
import jax, jax.numpy as jnp
from repro.configs.base import registry
from repro.models.model import build_model
from repro.train.optimizer import AdamWConfig, init_opt_state
from repro.train.train_step import make_train_step

out = {}
for name in CASES:
    cfg = case_cfg(registry, name)
    model = build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(model.train_loss))(params,
                                                                 batch)
    step = jax.jit(make_train_step(model, AdamWConfig(
        lr=LR, warmup_steps=1, total_steps=10)))
    new, _, m = step(params, init_opt_state(params), batch)
    for tag, tree in (("init", params), ("grad", grads), ("step", new)):
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(k.key) for k in path)
            out[f"{name}|{tag}|{key}"] = np.asarray(a)
    out[f"{name}|loss"] = np.float64(loss)
    out[f"{name}|step_loss"] = np.float64(m["loss"])

# MICRO microbatches: rows i·B/MICRO … (i+1)·B/MICRO each (the reshape)
for name in MICRO_CASES:
    cfg = case_cfg(registry, name)
    model = build_model(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg).items()}
    vg = jax.jit(jax.value_and_grad(model.train_loss))
    gs = [vg(params, {k: v.reshape((MICRO, B // MICRO) + v.shape[1:])[i]
                      for k, v in batch.items()})[1] for i in range(MICRO)]
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / MICRO, *gs)
    step = jax.jit(make_train_step(model, AdamWConfig(
        lr=LR, warmup_steps=1, total_steps=10), n_micro=MICRO))
    new, _, m = step(params, init_opt_state(params), batch)
    for tag, tree in (("grad", grads), ("step", new)):
        for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(k.key) for k in path)
            out[f"{name}|micro|{tag}|{key}"] = np.asarray(a)
    out[f"{name}|micro|step_loss"] = np.float64(m["loss"])
np.savez(sys.argv[1], **out)
print("REF_OK")
'''

PREAMBLE = r'''
import datetime, os, sys, warnings
warnings.simplefilter("ignore")
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, d = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=120))
from repro_torch import convert
from repro_torch.configs.base import registry
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model, shardctx
from repro_torch.train import checkpoint as ck
from repro_torch.train import init_opt_state, make_train_step, value_and_grad
from repro_torch.train.optimizer import AdamWConfig


def tree_of(flat, name, tag):
    pre = f"{name}|{tag}|"
    tree = {}
    for k in flat.files:
        if k.startswith(pre):
            node = tree
            parts = k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[k]
    return tree


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# functional collective -> (kind, whether its size is the output's)
KINDS = {"all_gather_into_tensor": ("all-gather", True),
         "reduce_scatter_tensor": ("reduce-scatter", True),
         "all_reduce": ("all-reduce", False),
         "all_to_all_single": ("all-to-all", False)}


def nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class RealCount(TorchDispatchMode):
    """What this rank runs of a step over ``DTensor`` operands: DTensor
    ops pass on to DTensor, and of what it then runs on real tensors
    (not its propagation's global-shape ops over fake ones) the FLOPs by
    PyTorch's flop formulas, the bytes accessed (the dry-run's measure:
    an op other than a view or a collective reads its tensor operands
    once and writes its new outputs, or the operand it updates in place,
    once), and each functional collective's kind, bytes (the gathered or
    scattered output, else the operand) and group size."""

    def __init__(self):
        super().__init__()
        self.flops, self.bytes, self.coll = 0, 0, {}

    def records(self):
        return sorted([k, b, g, n] for (k, b, g), n in self.coll.items())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        tensors = [t for t in tree_leaves((args, kwargs, out))
                   if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) or t.is_meta for t in tensors):
            return out
        if func._overloadpacket in flop_registry:
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        schema = func._schema
        if (func.namespace not in ("_c10d_functional", "prim")
                and not func.is_view):
            self.bytes += nbytes((args, kwargs))
            if schema.is_mutable or all(r.alias_info is None
                                        for r in schema.returns):
                self.bytes += nbytes(out)
        name = schema.name.split("::")[-1]
        if func.namespace == "_c10d_functional" and name in KINDS:
            kind, by_out = KINDS[name]
            t = out if by_out else args[0]
            names = [a.name for a in func._schema.arguments]
            group = args[names.index("group_name")]
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            key = (kind, t.numel() * t.element_size(),
                   _resolve_process_group(group).size())
            self.coll[key] = self.coll.get(key, 0) + 1
        return out


def save_tree(res, prefix, tree):
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            res[prefix + "/".join(path)] = np.asarray(node)
    walk(tree, ())
'''

EIGHT = r'''
ref = np.load(os.path.join(d, "ref.npz"))
mesh = make_local_mesh(n_data=2, n_model=4, device="cpu")
res = {}
opt_cfg = AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)
for name in CASES:
    cfg = case_cfg(registry, name)
    model = build_model(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    for mode in ("plain", "sharded"):
        params = convert.lm_params_from_numpy(cfg, tree_of(ref, name, "init"),
                                              device="cpu")
        b = batch
        if mode == "sharded":
            shardctx.set_mesh_axes(mesh.mesh_dim_names, mesh)
            psh = SH.place_params(params, mesh, cfg)
            b = SH.place_batch(batch, mesh)
        loss, grads = value_and_grad(model, params, b)
        grads = {k: whole(g) for k, g in grads.items()}
        opt = init_opt_state(params)
        if mode == "sharded":
            SH.place_opt_state(opt, SH.opt_shardings(psh, mesh))
        _, _, m = make_train_step(model, opt_cfg)(params, opt, b)
        new = {k: whole(p).detach() for k, p in params.named_parameters()}
        if mode == "sharded":
            live = {"params": dict(params.named_parameters()), "opt": opt}
            ck.save(os.path.join(d, f"ckpt_{name}"), 1, live)
            shardctx.clear()
        res[f"{name}|{mode}|loss"] = np.float64(whole(loss))
        res[f"{name}|{mode}|step_loss"] = np.float64(whole(m["loss"]))
        save_tree(res, f"{name}|{mode}|grad|",
                  convert.lm_params_to_numpy(cfg, grads))
        save_tree(res, f"{name}|{mode}|step|",
                  convert.lm_params_to_numpy(cfg, new))
        res[f"{name}|{mode}|names"] = np.array(sorted(new))

# MICRO microbatches, plain and on the mesh
from repro_torch.train.train_step import _micro_batches
for name in MICRO_CASES:
    cfg = case_cfg(registry, name)
    model = build_model(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    for mode in ("plain", "sharded"):
        params = convert.lm_params_from_numpy(cfg, tree_of(ref, name, "init"),
                                              device="cpu")
        b = batch
        if mode == "sharded":
            shardctx.set_mesh_axes(mesh.mesh_dim_names, mesh)
            psh = SH.place_params(params, mesh, cfg)
            b = SH.place_batch(batch, mesh)
        grads = {}
        for mb in _micro_batches(b, MICRO):
            _, g = value_and_grad(model, params, mb)
            grads = {k: grads.get(k, 0) + whole(v) for k, v in g.items()}
        grads = {k: v / MICRO for k, v in grads.items()}
        opt = init_opt_state(params)
        if mode == "sharded":
            SH.place_opt_state(opt, SH.opt_shardings(psh, mesh))
        _, _, m = make_train_step(model, opt_cfg, n_micro=MICRO)(params, opt,
                                                                 b)
        new = {k: whole(p).detach() for k, p in params.named_parameters()}
        if mode == "sharded":
            shardctx.clear()
        res[f"{name}|micro|{mode}|step_loss"] = np.float64(whole(m["loss"]))
        save_tree(res, f"{name}|micro|{mode}|grad|",
                  convert.lm_params_to_numpy(cfg, grads))
        save_tree(res, f"{name}|micro|{mode}|step|",
                  convert.lm_params_to_numpy(cfg, new))

# one step on the mesh, counted on this rank as it runs
import json
for name in COUNT_CASES:
    cfg = case_cfg(registry, name)
    model = build_model(cfg, device="cpu")
    params = convert.lm_params_from_numpy(cfg, tree_of(ref, name, "init"),
                                          device="cpu")
    shardctx.set_mesh_axes(mesh.mesh_dim_names, mesh)
    psh = SH.place_params(params, mesh, cfg)
    opt = init_opt_state(params)
    SH.place_opt_state(opt, SH.opt_shardings(psh, mesh))
    b = SH.place_batch({k: torch.from_numpy(v)
                        for k, v in make_batch(cfg).items()}, mesh)
    res[f"{name}|count|args"] = np.int64(sum(
        t.to_local().numel() * t.to_local().element_size()
        for t in tree_leaves((dict(params.named_parameters()), opt, b))))
    count = RealCount()
    with count:
        make_train_step(model, AdamWConfig(), n_micro=MICRO).eager(params,
                                                                   opt, b)
    shardctx.clear()
    res[f"{name}|count|flops"] = np.int64(count.flops)
    res[f"{name}|count|bytes"] = np.int64(count.bytes)
    res[f"{name}|count|coll"] = np.array(json.dumps(count.records()))

# the reference test's tree, sharded over all 8 ranks
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
mesh8 = make_local_mesh(n_data=8, device="cpu")
sh8 = [Shard(0), Replicate()]
tree = {"w": distribute_tensor(torch.arange(64.0).reshape(8, 8), mesh8, sh8),
        "b": distribute_tensor(torch.ones(8), mesh8, sh8),
        "opt": {"m": distribute_tensor(torch.zeros((8, 8)), mesh8, sh8)}}
ck.save(os.path.join(d, "elastic"), 3, tree, extra={"pipeline_pos": 1234})
if rank == 0:
    np.savez(os.path.join(d, "eight.npz"), **res)
dist.barrier()
print("EIGHT_OK")
os._exit(0)
'''

# the dry-run of the counted step: a fake group of 8 as the same mesh
DRY = r'''
import json, sys, warnings
warnings.simplefilter("ignore")
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import SHAPES, registry
from repro_torch.launch import dryrun

mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
shape = dataclasses.replace(SHAPES["train_4k"], global_batch=B, seq_len=S)
out = {name: dryrun.trace_cell(case_cfg(registry, name), shape, mesh, "cpu",
                               MICRO) for name in COUNT_CASES}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("DRY_OK")
'''

FOUR = r'''
from torch.distributed.tensor import DTensor, Replicate, Shard
mesh4 = make_local_mesh(n_data=4, device="cpu")
res = {}
sh4 = SH.NamedSharding(mesh4, ("data",))
restored, manifest = ck.restore(os.path.join(d, "elastic"),
                                shardings={"w": sh4, "b": sh4,
                                           "opt": {"m": sh4}})
assert manifest["extra"]["pipeline_pos"] == 1234
assert isinstance(restored["w"], DTensor)
assert restored["w"].device_mesh.size() == 4
assert restored["w"].placements == (Shard(0), Replicate())
assert tuple(restored["w"].to_local().shape) == (2, 8)
for k in ("w", "b"):
    res[f"elastic|{k}"] = whole(restored[k]).numpy()
res["elastic|opt/m"] = whole(restored["opt"]["m"]).numpy()

# the reverse: a checkpoint of plain tensors restored onto the mesh
plain = {"w": torch.arange(24.0).reshape(8, 3), "b": torch.ones(8)}
ck.save(os.path.join(d, "plain"), 1, plain)
dist.barrier()
back, _ = ck.restore(os.path.join(d, "plain"), shardings=sh4)
assert all(isinstance(t, DTensor) for t in back.values())
for k, t in back.items():
    res[f"plain|{k}"] = whole(t).numpy()

# the sharded model state saved on 8 ranks, onto this mesh's rules
for name in CASES:
    cfg = case_cfg(registry, name)
    psh = SH.param_shardings(
        build_model(cfg, device="meta").param_axes(), cfg, mesh4)
    tree, _ = ck.restore(os.path.join(d, f"ckpt_{name}"), shardings={
        "params": psh, "opt": SH.opt_shardings(psh, mesh4)})
    for k, t in tree["params"].items():
        assert t.placements == tuple(psh[k].placements), k
        res[f"{name}|restored|{k}"] = whole(t).numpy()
    flat, _ = ck.restore(os.path.join(d, f"ckpt_{name}"), device="cpu")
    for k, t in flat["params"].items():
        res[f"{name}|saved|{k}"] = t.numpy()

# launch.train on this 4-rank mesh: cut after step 3 and relaunched
from repro_torch.launch import train as launch_train
args = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "6", "--batch", "4",
        "--seq", "16", "--ckpt-every", "3", "--log-every", "3",
        "--device", "cpu"]
full = launch_train.main(args + ["--ckpt-dir", os.path.join(d, "ta")])
cut = os.path.join(d, "tb")
launch_train.main(args + ["--ckpt-dir", cut])
dist.barrier()
if rank == 0:
    import shutil
    shutil.rmtree(os.path.join(cut, "step_6"))
    with open(os.path.join(cut, "latest"), "w") as f:
        f.write("3")
dist.barrier()
resumed = launch_train.main(args + ["--ckpt-dir", cut])
dist.barrier()
res["train|full"] = np.float64(full)
res["train|resumed"] = np.float64(resumed)
a, _ = ck.restore(os.path.join(d, "ta"), device="cpu")
b, ma = ck.restore(cut, device="cpu")
res["train|step"] = np.int64(ma["step"])
for k, t in ck._flatten(a).items():
    res[f"train|a|{k}"] = t.float().numpy()
    res[f"train|b|{k}"] = ck._flatten(b)[k].float().numpy()
if rank == 0:
    np.savez(os.path.join(d, "four.npz"), **res)
dist.barrier()
print("FOUR_OK")
os._exit(0)
'''


def _env():
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
           if k in os.environ}
    env["PYTHONPATH"] = str(ROOT / "src")
    # without it jax probes for a TPU backend and hangs on isolated hosts
    env["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS", "cpu")
    return env


def _wait(procs):
    for what, proc in procs:
        try:
            out, err = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for _, p in procs:
                p.kill()
            out, err = proc.communicate()
            raise AssertionError(f"{what} timed out\n{err[-3000:]}")
        assert proc.returncode == 0, f"{what}: {out}\n{err[-3000:]}"


def _ranks(code: str, world: int, d: Path):
    store = d / f"store{world}"
    return [(f"rank {r}/{world}", subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(store),
         str(d)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    common = textwrap.dedent(COMMON)
    _wait([("reference", subprocess.Popen(
        [sys.executable, "-c", common + textwrap.dedent(REF),
         str(d / "ref.npz")], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
    port = common + textwrap.dedent(PREAMBLE)
    dry = ("dry-run", subprocess.Popen(
        [sys.executable, "-c", common + textwrap.dedent(DRY),
         str(d / "dry.json")], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    _wait(_ranks(port + textwrap.dedent(EIGHT), 8, d) + [dry])
    _wait(_ranks(port + textwrap.dedent(FOUR), 4, d))
    return (np.load(d / "ref.npz"), np.load(d / "eight.npz"),
            np.load(d / "four.npz"), json.loads((d / "dry.json").read_text()))


def _leaves(flat, prefix):
    return {k[len(prefix):]: flat[k] for k in flat.files
            if k.startswith(prefix)}


def _loss_close(got, want):
    assert abs(float(got) - float(want)) <= F32_LOSS * abs(float(want)), (
        got, want)


def _grads_close(got: dict, want: dict, what):
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        assert err <= F32_GRAD * float(np.abs(w).max()), (what, k, err)


def _params_close(got: dict, want: dict, grads: dict, what):
    """Updated parameters: within 1e-6 of the leaf's largest magnitude
    plus what a gradient error ``G`` (the gradient bound) can move AdamW's
    first step ``lr·m̂/(√v̂ + eps)``: the step reads the gradient twice,
    in ``m`` and in ``v``, each within ``G`` of ``g``, so it moves by at
    most ``lr·2G/(|g| - G + eps)``, and never more than ``2·lr`` (a flip
    of its sign)."""
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        g = np.abs(grads[k]).astype(np.float64)
        G = F32_GRAD * float(g.max())
        low = np.maximum(g - G, 0.0)
        step = LR * np.minimum(2.0, 2.0 * G / (low + EPS))
        bound = F32_PARAM * float(np.abs(w).max()) + step
        err = np.abs(got[k].astype(np.float64) - w)
        assert (err <= bound).all(), (what, k, float((err - bound).max()))


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_the_unsharded_port(runs, case):
    _, eight, _, _ = runs
    pre, sh = f"{case}|plain|", f"{case}|sharded|"
    _loss_close(eight[sh + "loss"], eight[pre + "loss"])
    _loss_close(eight[sh + "step_loss"], eight[pre + "step_loss"])
    plain_grads = _leaves(eight, pre + "grad|")
    _grads_close(_leaves(eight, sh + "grad|"), plain_grads, case)
    _params_close(_leaves(eight, sh + "step|"), _leaves(eight, pre + "step|"),
                  plain_grads, case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_the_reference(runs, case):
    ref, eight, _, _ = runs
    sh = f"{case}|sharded|"
    _loss_close(eight[sh + "loss"], ref[f"{case}|loss"])
    _loss_close(eight[sh + "step_loss"], ref[f"{case}|step_loss"])
    ref_grads = _leaves(ref, f"{case}|grad|")
    _grads_close(_leaves(eight, sh + "grad|"), ref_grads, case)
    _params_close(_leaves(eight, sh + "step|"), _leaves(ref, f"{case}|step|"),
                  ref_grads, case)


def test_elastic_checkpoint_reshard(runs):
    """Saved on an (8, 1) mesh, restored onto a (4, 1) one (two rows a
    rank), bit for bit; and plain tensors saved, restored onto the mesh."""
    _, _, four, _ = runs
    np.testing.assert_array_equal(four["elastic|w"],
                                  np.arange(64.0).reshape(8, 8))
    np.testing.assert_array_equal(four["elastic|b"], np.ones(8))
    np.testing.assert_array_equal(four["elastic|opt/m"], np.zeros((8, 8)))
    np.testing.assert_array_equal(four["plain|w"],
                                  np.arange(24.0).reshape(8, 3))
    np.testing.assert_array_equal(four["plain|b"], np.ones(8))


@pytest.mark.parametrize("case", CASES)
def test_sharded_model_state_restores_onto_fewer_ranks(runs, case):
    """The state of a (2, 4) mesh, restored onto a (4, 1) mesh's rules:
    every parameter bit for bit."""
    _, _, four, _ = runs
    saved = _leaves(four, f"{case}|saved|")
    restored = _leaves(four, f"{case}|restored|")
    assert saved and saved.keys() == restored.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)


def test_launch_train_on_four_ranks_resumes_bit_for_bit(runs):
    """`launch.train.main` on a (4, 1) gloo mesh at SMOKE, cut after step
    3's checkpoint and relaunched: the same final loss and state."""
    _, _, four, _ = runs
    assert int(four["train|step"]) == 6
    assert float(four["train|resumed"]) == float(four["train|full"])
    assert np.isfinite(float(four["train|full"]))
    a, b = _leaves(four, "train|a|"), _leaves(four, "train|b|")
    assert a and a.keys() == b.keys()
    for k, v in a.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)


@pytest.mark.parametrize("case", MICRO_CASES)
def test_microbatched_sharded_step_matches_the_unsharded_port(runs, case):
    """Two microbatches on the (2, 4) mesh: microbatch i holds the global
    rows ``i·B/2 …`` as on plain tensors, so the accumulated gradient and
    the step match the plain port's within the f32 bounds."""
    _, eight, _, _ = runs
    pre, sh = f"{case}|micro|plain|", f"{case}|micro|sharded|"
    _loss_close(eight[sh + "step_loss"], eight[pre + "step_loss"])
    plain_grads = _leaves(eight, pre + "grad|")
    _grads_close(_leaves(eight, sh + "grad|"), plain_grads, case)
    _params_close(_leaves(eight, sh + "step|"), _leaves(eight, pre + "step|"),
                  plain_grads, case)


@pytest.mark.parametrize("mode", ["plain", "sharded"])
@pytest.mark.parametrize("case", MICRO_CASES)
def test_microbatched_step_matches_the_reference(runs, case, mode):
    """The port's step at two microbatches, plain and on the mesh, against
    the reference's jitted ``make_train_step(..., n_micro=2)``."""
    ref, eight, _, _ = runs
    got = f"{case}|micro|{mode}|"
    _loss_close(eight[got + "step_loss"], ref[f"{case}|micro|step_loss"])
    ref_grads = _leaves(ref, f"{case}|micro|grad|")
    _grads_close(_leaves(eight, got + "grad|"), ref_grads, case)
    _params_close(_leaves(eight, got + "step|"),
                  _leaves(ref, f"{case}|micro|step|"), ref_grads, case)


@pytest.mark.parametrize("case", COUNT_CASES)
def test_dry_run_counts_equal_a_real_rank(runs, case):
    """The dry-run of one step on a fake (2, 4) mesh against rank 0 of the
    real one: FLOPs, argument bytes and every collective's kind, bytes,
    group and count exactly; bytes accessed within 1% (``BYTES_REL``).
    Fake tensors do not always take the strides the real kernels give
    (an attention output whose size-1 head axis has another stride), so
    the fake step copies where the real one views: qwen3 +0.49%,
    granite-moe -0.22%.  Ops DTensor's propagation runs over global
    shapes, were they counted, would add 30-70%."""
    _, eight, _, dry = runs
    rec = dry[case]
    assert rec["ok"] and rec["devices"] == 8 and rec["device_type"] == "cpu"
    assert rec["n_micro"] == 2
    assert rec["cost"]["flops"] == int(eight[f"{case}|count|flops"]) > 0
    real_bytes = int(eight[f"{case}|count|bytes"])
    assert real_bytes > 0 and abs(rec["cost"]["bytes accessed"]
                                  - real_bytes) <= BYTES_REL * real_bytes, (
        rec["cost"]["bytes accessed"], real_bytes)
    assert rec["memory"]["argument_size_in_bytes"] == int(
        eight[f"{case}|count|args"])
    real = json.loads(str(eight[f"{case}|count|coll"]))
    assert {kind for kind, _, _, _ in real} >= {"all-gather", "all-reduce"}
    assert sorted([c["kind"], c["bytes"], c["group"], c["count"]]
                  for c in rec["coll"]) == real
