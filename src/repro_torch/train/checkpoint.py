"""Fault-tolerant checkpointing (port of ``repro.train.checkpoint``).

The contract and the on-disk format are the reference's, so either
package restores what the other saved:

* **Atomicity** — a checkpoint is written to ``step_N.tmp/`` and renamed
  to ``step_N/`` only after its manifest is fsync'd; the ``latest``
  pointer is replaced after the rename.  A crash mid-write never corrupts
  the latest checkpoint.
* **Format** — ``arrays.npz`` holds every leaf under its tree path with
  ``/`` written as ``::``; ``manifest.json`` holds the step, the keys,
  the shapes, each leaf's logical dtype name and the caller's ``extra``
  (the data-pipeline cursor).  bfloat16 and float8 leaves, which numpy
  cannot hold, are stored as same-width integer views (``uint16``,
  ``uint8``) and viewed back on restore.
* **Restore** — returns tensors on a device, or, with ``into=`` (a tree of
  the same leaves), writes every leaf into the existing tensors
  (``copy_``), so a captured train step goes on replaying over them.
  Without a step it falls back past a corrupt or partial newest
  checkpoint with a warning; an explicitly requested step raises.
* **Elastic restart** — a ``DTensor`` leaf (a tensor laid over a mesh) is
  saved whole, gathered on every rank and written by rank 0 alone, in
  the same layout as an unsharded one; ``restore(..., shardings=)`` lays
  each leaf over the current mesh (a tree or one sharding with a
  ``mesh`` and ``placements``, as ``launch.sharding.NamedSharding``), so a
  checkpoint saved on 8 ranks restores onto 4, sharded restores
  unsharded, and the reverse.
* **Async** — ``save(..., blocking=False)`` copies the leaves to the host
  first, then writes on a thread; training continues.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve
from ..models.shardctx import is_sharded

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

# logical dtype name -> (torch dtype, the same-width integer view it is
# stored as: torch's and numpy's)
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}


def _whole(x):
    """A leaf as one tensor: a ``DTensor`` gathered (a collective: every
    rank of its mesh calls it)."""
    return x.full_tensor() if is_sharded(x) else x


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of the default
    process group, or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_storable(x):
    """``(array, logical dtype name)`` of a leaf (a tensor or an array)."""
    if not torch.is_tensor(x):
        a = np.array(x, copy=True)
        return a, a.dtype.name
    t = _whole(x.detach()).cpu().contiguous()
    for name, (dt, bits, view) in _EXOTIC.items():
        if t.dtype == dt:
            return t.view(bits).numpy().view(view).copy(), name
    a = t.numpy().copy()
    return a, a.dtype.name


def _from_storable(a: np.ndarray, logical: str) -> torch.Tensor:
    if logical not in _EXOTIC:
        return torch.from_numpy(np.array(a, copy=True))
    dt, _, view = _EXOTIC[logical]
    bits = np.ascontiguousarray(a).view(view)
    if bits.size == 0:
        return torch.empty(bits.shape, dtype=dt)
    return torch.frombuffer(bytearray(bits.tobytes()), dtype=dt).reshape(
        bits.shape)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return root


def save(ckpt_dir: str, step: int, tree: Dict[str, Any],
         extra: Optional[dict] = None, blocking: bool = True):
    """Save a tree of tensors or arrays atomically.  Returns the final
    path, or with ``blocking=False`` the writer thread (the leaves are on
    the host before it starts).  Under a process group every rank calls
    it (``DTensor`` leaves are gathered) and rank 0 writes: the others
    return the path, or None for a thread."""
    host, logical_dtypes = {}, {}
    for k, v in _flatten(tree).items():
        host[k], logical_dtypes[k] = _to_storable(v)
    if not _writer():
        return None if not blocking else os.path.join(ckpt_dir,
                                                      f"step_{step}")

    def write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "::"): v for k, v in host.items()})
        manifest = {
            "step": step,
            "keys": sorted(host),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": logical_dtypes,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(ckpt_dir, "latest.tmp"),
                   os.path.join(ckpt_dir, "latest"))

    if blocking:
        write()
        return os.path.join(ckpt_dir, f"step_{step}")
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t  # caller may join


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _available_steps(ckpt_dir: str) -> list:
    """Finalized checkpoint steps on disk, newest first."""
    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return []
    steps = []
    for d in entries:
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps, reverse=True)


def _load_step(ckpt_dir: str, step: int) -> tuple:
    """``(flat leaves as CPU tensors, manifest)``; every leaf is read before
    it returns, so a corrupt payload raises here."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        flat = {k: _from_storable(data[k.replace("/", "::")],
                                  manifest["dtypes"].get(k, ""))
                for k in manifest["keys"]}
    return flat, manifest


def _laid(flat: dict, shardings) -> dict:
    """``flat``'s leaves laid over their shardings' meshes (``DTensor``
    objects); a leaf with no sharding stays as it is."""
    from torch.distributed.tensor import distribute_tensor
    per_leaf = _flatten(shardings) if isinstance(shardings, dict) else None
    out = {}
    for k, v in flat.items():
        sh = per_leaf.get(k) if per_leaf is not None else shardings
        if sh is None:
            out[k] = v
            continue
        mesh = sh.mesh
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
        out[k] = distribute_tensor(v.to(dev), mesh, sh.placements,
                                   src_data_rank=None)
    return out


def _place(flat: dict, device, into, shardings=None) -> Any:
    if shardings is not None:
        flat = _laid(flat, shardings)
    if into is None:
        if shardings is not None:
            return _unflatten(flat)
        dev = resolve(device)
        return _unflatten({k: v.to(dev) for k, v in flat.items()})
    target = _flatten(into)
    if target.keys() != flat.keys():
        raise KeyError(f"checkpoint leaves {sorted(flat)} do not match "
                       f"the target's {sorted(target)}")
    for k, t in target.items():
        if tuple(t.shape) != tuple(flat[k].shape) or t.dtype != flat[k].dtype:
            raise ValueError(f"{k}: checkpoint {tuple(flat[k].shape)} "
                             f"{flat[k].dtype}, target {tuple(t.shape)} "
                             f"{t.dtype}")
    with torch.no_grad():
        for k, t in target.items():
            v = flat[k]
            if is_sharded(t) and not is_sharded(v):
                # the whole leaf, laid as the live tensor is laid
                from torch.distributed.tensor import distribute_tensor
                v = distribute_tensor(v.to(t.to_local().device),
                                      t.device_mesh, t.placements,
                                      src_data_rank=None)
            t.copy_(v)
    return into


def restore(ckpt_dir: str, step: Optional[int] = None, device=None,
            into=None, shardings=None):
    """Restore a checkpoint: ``(tree, manifest)``, the tree's leaves as
    tensors on ``device`` (CUDA unless ``"cpu"`` is asked for), or laid
    over a mesh by ``shardings`` (a tree of the same leaves, or one for
    all: each with a ``mesh`` and ``placements``), or written into
    ``into`` (a tree of tensors with the same leaves, shapes and dtypes;
    a ``DTensor`` there takes the leaf laid as it is), which is returned.
    ``(None, None)`` when there is none.

    With ``step=None`` (restart discovery), a corrupt or partially
    written newest checkpoint — a truncated ``arrays.npz`` or
    ``manifest.json`` next to an intact ``latest`` pointer — falls back to
    the next older finalized checkpoint with a warning instead of raising.
    An explicitly requested ``step`` still raises: the caller asked for
    *that* state.  Nothing is written into ``into`` unless a whole
    checkpoint was read."""
    if into is None and shardings is None:
        resolve(device)
    if step is not None:
        flat, manifest = _load_step(ckpt_dir, step)
        return _place(flat, device, into, shardings), manifest
    newest = latest_step(ckpt_dir)
    candidates = _available_steps(ckpt_dir)
    if newest is not None:
        # the pointer leads; older finalized dirs follow, newest first
        candidates = [newest] + [s for s in candidates if s != newest]
    if not candidates:
        return None, None
    errors = []
    for s in candidates:
        try:
            flat, manifest = _load_step(ckpt_dir, s)
        except Exception as e:  # truncated npz/json, missing file, ...
            errors.append((s, e))
            continue
        for prev, err in errors:
            warnings.warn(
                f"checkpoint step_{prev} is corrupt or incomplete "
                f"({type(err).__name__}: {err}); restored step_{s} instead",
                RuntimeWarning, stacklevel=2)
        return _place(flat, device, into, shardings), manifest
    raise RuntimeError(
        f"no restorable checkpoint in {ckpt_dir!r}: "
        + "; ".join(f"step_{s}: {type(e).__name__}: {e}"
                    for s, e in errors))


class CheckpointManager:
    """Keep-last-K rotation + async writes + restart discovery."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, tree, extra=None, blocking=False):
        if self._pending is not None:
            self._pending.join()  # one in flight at a time
            self._pending = None
        res = save(self.dir, step, tree, extra, blocking=blocking)
        if not blocking:
            self._pending = res
        self._gc()
        return res

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, device=None, into=None, shardings=None):
        """The newest checkpoint (see :func:`restore`).  Under a process
        group every rank calls it, after rank 0's write in flight."""
        import torch.distributed as dist
        self.wait()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        return restore(self.dir, None, device, into, shardings)

    def _gc(self):
        if not _writer():
            return
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
