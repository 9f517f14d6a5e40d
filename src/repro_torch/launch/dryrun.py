"""Multi-pod dry-run: trace every (arch × shape × mesh) cell (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step over 512
placeholder devices and reads XLA's memory and cost analyses.  The port
runs one *eager* step of the cell, in one process, over:

1. a ``fake`` process group of 256 (``single``: the (16, 16) mesh) or 512
   (``multi``: (2, 16, 16)) ranks, whose collectives do nothing, or with
   ``--mesh local`` a (1, 1) mesh over a real 1-rank group (NCCL on the
   card; gloo with ``--device cpu``);
2. the production mesh and its axes declared to ``models.shardctx``;
3. parameters, AdamW state and the shape's inputs as fake tensors
   (``FakeTensorMode``: shapes, dtypes and devices, no memory), laid out
   as ``DTensor`` objects by ``launch.sharding``, on ``cuda`` (the card
   is the target, and nothing is allocated on it) unless ``--device cpu``
   asks for ``cpu``: there is no other way on a host without a card,
   where PyTorch cannot slice a fake CUDA tensor, and it is not the
   card's program: PyTorch picks some kernels by device type, and
   DTensor's sharding strategies and collectives with them (qwen3-1.7b's
   train cell runs 112 more all-reduces on CUDA tensors, and DTensor
   moves a shard between dimensions by all-to-all on CUDA groups but by
   all-gather on CPU ones), so the collective record differs.  Every
   record says which (``device_type``);
4. the step, traced by :class:`repro_torch.roofline.analysis.StepTrace`:
   ``make_train_step(model, AdamWConfig(), n_micro)``'s eager step for a
   train shape (4 microbatches, as the reference), the prefill, or one
   decode step.

Per cell it records the argument bytes of one rank (its shards of the
parameters, optimizer state and inputs; a prefill's caches, which the
port preallocates and fills in place, among them), the trace's peak of
live bytes as ``temp`` (a model of the eager allocator, see
``StepTrace``), the local program's FLOPs and bytes accessed, the
collectives, the model FLOPs (6·N_active·T/n_dev for training, 2· for
serving) and the roofline terms on the H100's constants.  A cell that
raises is recorded as data (``ok: false``, the error and the end of its
traceback).  The reference's second, layers-unrolled lowering has no
counterpart (an eager trace sees every FLOP once), so ``scan_layers`` is
ignored.

Usage (without a card, add ``--device cpu``):
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh single --json out/cell.json
  python -m repro_torch.launch.dryrun --all --out-dir out/dryrun --mesh both
  python -m repro_torch.launch.dryrun --all --shape train_4k --jobs 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

__all__ = ["run_cell", "trace_cell", "all_cells", "main"]

SIZES = {"single": 256, "multi": 512}


def _start_group(mesh_kind: str, device=None):
    """The cell's process group and mesh, and its device type: ``cuda``
    unless ``device`` says otherwise (see the module docstring)."""
    import torch.distributed as dist
    from .mesh import make_local_mesh, make_production_mesh
    dev = _device_type(device)
    if mesh_kind == "local":
        return make_local_mesh(device=dev), dev
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=SIZES[mesh_kind])
    return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=dev), dev


def _fake_params(cfg, dev):
    """The model's parameter module with fake tensors on ``dev`` (built on
    ``meta``: no generator runs, nothing is drawn)."""
    import torch
    from ..models.model import build_model
    params = build_model(cfg, device="meta").init()
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        mod._parameters[leaf] = torch.nn.Parameter(
            torch.empty(p.shape, dtype=p.dtype, device=dev),
            requires_grad=False)
    return params


def _fake(t, dev):
    import torch
    return torch.empty(t.shape, dtype=t.dtype, device=dev)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    from ..models.layers import KVCache
    if isinstance(tree, KVCache):
        tree = [tree.k, tree.v, tree.pos]
    elif isinstance(tree, (list, tuple)):
        return sum(_local_bytes(t) for t in tree)
    elif isinstance(tree, dict):
        return sum(_local_bytes(t) for t in tree.values())
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _place_caches(caches, shardings):
    from ..models.layers import KVCache
    from .sharding import place
    out = []
    for st, sh in zip(caches, shardings):
        if isinstance(st, KVCache):
            out.append(KVCache(place(st.k, sh.k), place(st.v, sh.v),
                               place(st.pos, sh.pos), st.window))
        else:
            out.append({k: place(v, sh[k]) for k, v in st.items()})
    return out


def _trace_step(cfg, shape, mesh, dev, n_micro: int):
    """Build the cell's state as fake ``DTensor`` objects and trace one
    step.  Returns ``(trace, argument bytes, seconds)``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models.model import build_model
    from ..roofline.analysis import StepTrace
    from ..train.optimizer import AdamWConfig, init_opt_state
    from ..train.train_step import make_train_step
    from . import sharding as SH

    model = build_model(cfg, device=dev)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_params(cfg, dev)
        psh = SH.place_params(params, mesh, cfg)
        specs = model.input_specs(shape)
        args_bytes = _local_bytes(dict(params.named_parameters()))
        t0 = time.time()
        if shape.kind == "train":
            opt = SH.place_opt_state(init_opt_state(params),
                                     SH.opt_shardings(psh, mesh))
            batch = SH.place_batch({k: _fake(v, dev) for k, v in
                                    specs.items()}, mesh)
            args_bytes += _local_bytes(opt) + _local_bytes(batch)
            step = make_train_step(model, AdamWConfig(), n_micro=n_micro)
            t0 = time.time()
            with StepTrace() as trace:
                step.eager(params, opt, batch)
            return trace, args_bytes, time.time() - t0
        B, S = shape.global_batch, shape.seq_len
        caches = model.init_cache(B, S)
        caches = _place_caches(caches, SH.cache_shardings(
            model.cache_axes(S), caches, cfg, mesh))
        inputs = SH.place_batch({k: _fake(v, dev) for k, v in specs.items()
                                 if k != "caches"}, mesh)
        args_bytes += _local_bytes(caches) + _local_bytes(inputs)
        t0 = time.time()
        with torch.no_grad(), StepTrace() as trace:
            if shape.kind == "prefill":
                frames = [inputs["frames"]] if "frames" in inputs else []
                model.prefill(params, inputs["tokens"], *frames,
                              max_len=S, caches=caches)
            else:
                rest = [inputs["enc_out"]] if "enc_out" in inputs else []
                model.decode_step(params, caches, inputs["tokens"],
                                  inputs["pos"], *rest)
        return trace, args_bytes, time.time() - t0


def _device_type(device) -> str:
    from ..device import resolve
    return resolve(device).type


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v.lower() in ("true", "false"):
        v = v.lower() == "true"
    else:
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
    return k, v


def trace_cell(cfg, shape, mesh, dev, n_micro: int) -> dict:
    """One cell's record (without its names) over ``mesh``, on whose
    ranks the process group already runs: the step traced with the
    mesh's axes declared to ``shardctx``."""
    from ..models import shardctx
    from ..roofline.analysis import roofline
    shardctx.set_mesh_axes(mesh.mesh_dim_names, mesh)
    try:
        trace, args_bytes, lower_s = _trace_step(cfg, shape, mesh, dev,
                                                 n_micro)
    finally:
        shardctx.clear()
    n_dev = mesh.size()
    n_active = cfg.n_active_params()
    tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops = mult * n_active * tokens / n_dev
    cost = {"flops": float(trace.flops),
            "bytes accessed": float(trace.bytes)}
    coll = trace.records()
    return {
        "ok": True, "devices": n_dev, "device_type": str(dev),
        "n_micro": n_micro, "lower_s": round(lower_s, 1),
        "memory": {"argument_size_in_bytes": args_bytes,
                   "temp_size_in_bytes": trace.peak_bytes},
        "per_device_bytes": args_bytes + trace.peak_bytes,
        "coll": coll, "cost": cost,
        "roofline": roofline(cost, coll, model_flops).to_dict(),
    }


def _cell(arch: str, shape_name: str, mesh_kind: str, trace_dir=None,
          overrides=(), micro=None, batch=None, seq=None,
          device=None) -> dict:
    from ..configs.base import SHAPES, get_config
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **dict(overrides))
    shape = SHAPES[shape_name]
    if batch or seq:
        shape = dataclasses.replace(shape, global_batch=batch or
                                    shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    mesh, dev = _start_group(mesh_kind, device)
    res = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           **trace_cell(cfg, shape, mesh, dev,
                        micro or (4 if shape.kind == "train" else 1))}
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        with open(os.path.join(
                trace_dir, f"{arch}_{shape_name}_{mesh_kind}.json"),
                "w") as f:
            json.dump({"cost": res["cost"], "collectives": res["coll"]},
                      f, indent=1)
    return res


def run_cell(arch, shape, mesh_kind, json_path=None, trace_dir=None,
             overrides=(), micro=None, batch=None, seq=None, device=None):
    try:
        res = _cell(arch, shape, mesh_kind, trace_dir, overrides, micro,
                    batch, seq, device)
        if overrides:
            res["overrides"] = dict(overrides)
    except Exception as e:  # record failures as data, not crashes
        res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "device_type": _device_type(device), "ok": False,
               "error": f"{type(e).__name__}: {e}"[:2000],
               "trace": traceback.format_exc()[-2000:]}
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump(res, f, indent=1)
    return res


def all_cells():
    """The (arch × shape) grid, minus the reference's documented skip:
    long_500k needs a sub-quadratic model."""
    from ..configs.base import SHAPES, get_config, registry
    cells = []
    for arch in sorted(registry()):
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic:
                continue
            cells.append((arch, shape.name))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "local"])
    ap.add_argument("--json")
    ap.add_argument("--trace-dir")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value")
    ap.add_argument("--micro", type=int, default=None,
                    help="gradient-accumulation microbatches (train)")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch, overridden")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's sequence length, overridden")
    ap.add_argument("--device", default=None,
                    help="cpu to trace CPU tensors over CPU groups, where "
                    "there is no card (default: cuda)")
    ap.add_argument("--all", action="store_true",
                    help="every cell of all_cells() (only those of --arch "
                    "and --shape where given), each in its own process")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --all, cells traced at once")
    ap.add_argument("--out-dir", default="out/dryrun")
    ap.add_argument("--timeout", type=int, default=2400)
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    _device_type(args.device)   # no card and no --device cpu: raise

    if not args.all:
        if len(meshes) > 1:
            # one process group per process: a cell per mesh, each apart
            return max(_subprocess(args.arch, args.shape, mk, args.json and
                                   _suffixed(args.json, mk), args)[0]
                       for mk in meshes)
        ov = tuple(_parse_override(kv) for kv in args.set)
        res = run_cell(args.arch, args.shape, meshes[0], args.json,
                       args.trace_dir, ov, args.micro, args.batch, args.seq,
                       args.device)
        print(json.dumps({k: v for k, v in res.items()
                          if k not in ("trace", "coll")}, indent=1))
        return 0 if res["ok"] else 1

    os.makedirs(args.out_dir, exist_ok=True)
    todo = []
    for arch, shape in all_cells():
        if args.arch not in (None, arch) or args.shape not in (None, shape):
            continue
        for mk in meshes:
            out = os.path.join(args.out_dir, f"{arch}_{shape}_{mk}.json")
            if os.path.exists(out):
                with open(out) as f:
                    prev = json.load(f)
                if prev.get("ok"):
                    print(f"SKIP (cached) {arch} {shape} {mk}", flush=True)
                    continue
            todo.append((arch, shape, mk, out))

    def one(cell):
        t0 = time.time()
        rc, _ = _subprocess(*cell, args)
        print(f"{'OK  ' if rc == 0 else 'FAIL'} {cell[0]:24s} {cell[1]:12s} "
              f"{cell[2]} ({time.time() - t0:.0f}s)", flush=True)
        return rc

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        failures = sum(rc != 0 for rc in pool.map(one, todo))
    return 1 if failures else 0


def _suffixed(path: str, mesh_kind: str) -> str:
    root, ext = os.path.splitext(path)
    return f"{root}_{mesh_kind}{ext}"


def _subprocess(arch, shape, mesh_kind, out, args):
    """One cell in its own process (its own process group, memory and
    failures), killed at ``args.timeout``; a timeout is recorded as a
    failed cell.  Returns (exit code, output)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh_kind]
    if out:
        cmd += ["--json", out]
    if args.trace_dir:
        cmd += ["--trace-dir", args.trace_dir]
    for kv in args.set:
        cmd += ["--set", kv]
    for flag in ("micro", "batch", "seq", "device"):
        if getattr(args, flag):
            cmd += [f"--{flag}", str(getattr(args, flag))]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=args.timeout)
        return p.returncode, p.stdout
    except subprocess.TimeoutExpired:
        if out:
            with open(out, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "device_type": _device_type(args.device),
                           "ok": False, "error": "trace timeout"}, f)
        return 1, ""


if __name__ == "__main__":
    sys.exit(main())
