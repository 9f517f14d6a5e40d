"""Deterministic, resumable data pipelines (port of
``repro.data.pipeline``).

A pipeline is a pure function of ``(seed, step)``: any worker can
regenerate any batch, and a restart is exact when the checkpoint stores
the step.  Batches are drawn with numpy's ``default_rng((seed << 20) +
step)``, as the reference draws them, so both packages yield the same
batches bit for bit; they are built on the host and copied to the device
through pinned memory without blocking (PyTorch's pinned-memory pool keeps
a staging buffer until its copy has run).

``StreamFeaturePipeline`` runs a compiled TiLT query as the feature
extractor over a raw signal stream: each ``next()`` advances a continuous
``StreamRunner`` one partition.  Its state (the step and the runner's
carried tails) is checkpointable, so feature extraction resumes exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve

__all__ = ["TokenPipeline", "StreamFeaturePipeline"]


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


@dataclasses.dataclass
class TokenPipeline:
    """Synthetic LM token batches (B, S) with next-token labels, on
    ``device`` (CUDA unless ``"cpu"`` is asked for)."""

    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    device: object = None

    def __post_init__(self):
        self.device = resolve(self.device)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict):
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    def next(self) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed << 20) + self.step)
        # every token is emitted twice in a row: the second occurrence is
        # exactly predictable, so CE has a clean learnable floor ≈ ½·ln V
        base = rng.integers(0, self.cfg.vocab,
                            (self.batch, self.seq // 2 + 1))
        toks = np.repeat(base, 2, axis=1)[:, :self.seq + 1].astype(np.int32)
        self.step += 1
        batch = {"tokens": _put(np.ascontiguousarray(toks[:, :-1]),
                                self.device),
                 "labels": _put(np.ascontiguousarray(toks[:, 1:]),
                                self.device)}
        if self.cfg.family == "encdec":
            frames = rng.normal(
                0, 1, (self.batch, self.cfg.enc_seq, self.cfg.d_model))
            batch["frames"] = _put(frames.astype(np.float32), self.device)
        return batch


@dataclasses.dataclass
class StreamFeaturePipeline:
    """TiLT query as a training-data feature extractor.

    Wraps a compiled TiLT query + a raw-signal generator; each ``next()``
    advances the continuous ``StreamRunner`` one partition (on ``device``,
    CUDA unless ``"cpu"`` is asked for) and returns its output grid (the
    values and their validity).
    """

    exe: object          # core.compile.CompiledQuery
    gen_seed: int = 0
    step: int = 0
    device: object = None

    def __post_init__(self):
        from ..core.parallel import StreamRunner
        self.device = resolve(self.device)
        self.runner = StreamRunner(self.exe)

    def state(self) -> dict:
        return {"step": self.step, "runner": self.runner.state()}

    def restore(self, state: dict):
        self.step = int(state["step"])
        self.runner.restore(state["runner"])

    def next(self):
        from ..core.stream import SnapshotGrid
        rng = np.random.default_rng((self.gen_seed << 20) + self.step)
        chunks = {}
        for name, spec in self.exe.input_specs.items():
            core = (self.exe.out_len * self.exe.out_prec) // spec.prec
            vals = rng.normal(0, 1, core).astype(np.float32)
            chunks[name] = SnapshotGrid(
                value=_put(vals, self.device),
                valid=torch.ones((core,), dtype=torch.bool,
                                 device=self.device),
                t0=0, prec=spec.prec)
        self.step += 1
        return self.runner.step(chunks)
