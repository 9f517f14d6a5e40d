"""Ahead-of-time step capture and persisted capture manifests for the
serving loop (port of ``repro.serve.aot``).

A served :class:`repro_torch.engine.Runner` runs a small, fully enumerable
set of steps (``Runner.aot_keys``).  :func:`aot_capture` prepares each one
before the first chunk (``Runner.install_executable``): on a CUDA device
it warms the step up and captures its CUDA graph over the runner's live
buffers, so the first real chunk is already a replay and the steady state
records no capture; on the CPU it builds the eager step.

**How this differs from the reference.**  The reference serializes each
compiled executable (``jax.experimental.serialize_executable``) and a warm
process loads it: it traces and compiles nothing.  A CUDA graph cannot be
serialized — it holds device addresses of the process that captured it —
so :class:`ExecutableCache` persists, per step fingerprint, a **capture
manifest** instead: the step's key, the capacity-bucket ladder and the
hold seeds' shapes.  A warm process (``build_service``) that finds the
plan artifact and every manifest, each naming the key and the ladder of
the rebuilt runner (:func:`manifest_fits`), rebuilds the runner without
planning and sizes its buffers without evaluating the body; the graphs
themselves are captured anew in every process.  Writes are atomic (tempfile +
rename); a torn or stale manifest is removed and degrades to the cold
path, never an error.

The reference's ``enable_jax_compilation_cache`` has no counterpart: the
one compiled artifact, the kernel library, is already cached across
processes under ``build/kernels/``, keyed by a hash of its sources.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Dict, Optional

import torch

from ..core import ir
from ..core import sparse as sparse_mod
from ..multiquery.shared import load_plain

__all__ = ["ExecutableCache", "aot_capture", "capture_manifest",
           "manifest_fits", "step_fingerprint"]

_MANIFEST_SCHEMA = "repro_torch.capture/v1"


def _backend_tag() -> tuple:
    name = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    return (torch.__version__, torch.version.cuda, name)


def step_fingerprint(runner, label: str, *,
                     query_fp: Optional[str] = None) -> str:
    """Process-stable content key of one step: the query structure, the
    execution geometry, the metrics mode and the backend (torch's version,
    the CUDA version and the card's name).  Two processes that would
    capture the same step agree on it; any drift misses."""
    spec = runner.spec
    if query_fp is None:
        if spec.root is not None:
            query_fp = ir.fingerprint(spec.root)
        else:
            # opaque body: fall back to the planning artifacts (pure-data
            # dataclass reprs are deterministic)
            query_fp = repr((sorted(spec.input_specs.items()),
                             spec.change_plan))
    p = runner.policy
    payload = repr((query_fp, label, spec.out_len, spec.out_prec,
                    sorted(spec.out_precs.items()), spec.solo,
                    p.body, p.keys, p.dag, p.placement,
                    runner.n_keys, runner.n_segs, runner.metrics.on,
                    runner.revision_horizon, _backend_tag()))
    return hashlib.sha256(payload.encode()).hexdigest()


def _ladder(runner) -> list:
    return sparse_mod.capacity_ladder(runner.n_keys * runner.n_segs)


def capture_manifest(runner, key, device=None) -> dict:
    """What a warm process needs to rebuild ``runner``'s step ``key``
    without planning or evaluating the body: the key, the capacity-bucket
    ladder and the hold seeds' shapes (``Runner.seed_shape_spec``)."""
    return {"schema": _MANIFEST_SCHEMA, "key": tuple(key),
            "caps": _ladder(runner),
            "seed_shapes": runner.seed_shape_spec(device)}


def manifest_fits(manifest: Optional[dict], runner, key) -> bool:
    """Whether ``manifest`` was written for ``runner``'s step ``key``: the
    same key and the same capacity-bucket ladder (a stale entry reads as
    a miss)."""
    return (manifest is not None and manifest.get("key") == tuple(key)
            and manifest.get("caps") == _ladder(runner))


class ExecutableCache:
    """Directory of capture manifests, one pickle per step fingerprint.
    Writes are atomic (tempfile + rename), so concurrent servers warming
    the same directory never read a torn entry; a corrupt one is removed
    and reads as a miss."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)

    def _file(self, fp: str) -> str:
        return os.path.join(self.path, f"{fp}.capture")

    def load(self, fp: str) -> Optional[dict]:
        """The manifest, or ``None`` on a miss or a torn/stale entry."""
        try:
            with open(self._file(fp), "rb") as f:
                doc = load_plain(f)
            if not (isinstance(doc, dict)
                    and doc.get("schema") == _MANIFEST_SCHEMA):
                raise ValueError("not a capture manifest")
            return doc
        except FileNotFoundError:
            return None
        except Exception:
            # a torn/stale entry (interrupted writer, older schema)
            # degrades to the cold path, never an error
            try:
                os.remove(self._file(fp))
            except OSError:
                pass
            return None

    def store(self, fp: str, manifest: dict) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(manifest, f)
            os.replace(tmp, self._file(fp))
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise


def aot_capture(runner, cache: Optional[ExecutableCache] = None, *,
                chunks: Optional[Dict] = None,
                query_fp: Optional[str] = None,
                device=None) -> Dict[str, str]:
    """Prepare every step ``runner`` runs, ahead of its first chunk, over
    the layout of ``chunks`` (default ``runner.example_chunks(device)``):
    captured on the card, built on the CPU.  With ``cache`` each step's
    capture manifest is written where it is missing or stale (the cold
    path leaves a warm start behind).

    Returns ``{step label: "captured" | "eager"}``.
    """
    if chunks is None:
        chunks = runner.example_chunks(device)
    report: Dict[str, str] = {}
    for label, key in runner.aot_keys():
        report[label] = runner.install_executable(key, label=label,
                                                  chunks=chunks)
    if cache is not None:
        for label, key in runner.aot_keys():
            fp = step_fingerprint(runner, label, query_fp=query_fp)
            if not manifest_fits(cache.load(fp), runner, key):
                cache.store(fp, capture_manifest(runner, key))
    return report
