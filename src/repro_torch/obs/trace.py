"""Phase tracing: wall-time span trees and a recompile detector; port of
``repro.obs.trace``.

Spans answer "where does the wall time go" at phase granularity —
plan / compile / execute / refit — without a profiler run.  ``span()``
is a context manager; nesting builds slash-separated paths
(``session.rebuild/plan``), and each path aggregates count / total / max
seconds.  This is *host* wall time around dispatch boundaries: spans
never touch device values, so they are safe anywhere, including around
the sync-checked hot path.

The recompile detector rides the engine's own staging discipline: every
miss in ``Runner``'s ``step_cache`` (one built step per (policy,
geometry) point) calls :meth:`Tracer.record_compile` with the cache key.
A key built **more than once** means the cache was dropped and rebuilt —
an unexpected rebuild; :meth:`Tracer.retraces` surfaces exactly those.
On the card a runner also captures each step's CUDA graph once, at its
first use: :meth:`Tracer.record_capture` counts captures per label where
the reference counts compiles, and a steady state records none.

Optional passthrough: with ``REPRO_OBS_JAX_TRACE=1`` (the reference's
switch, kept under its name), spans also open
``torch.profiler.record_function`` so they appear on the profiler's
timeline when a trace is active.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

__all__ = ["Tracer"]


def _annotation(name: str):
    if os.environ.get("REPRO_OBS_JAX_TRACE", "0") != "1":
        return contextlib.nullcontext()
    import torch.profiler
    return torch.profiler.record_function(name)


class Tracer:
    """Aggregating span recorder + per-key compile counter."""

    def __init__(self):
        self._stack: List[str] = []
        self._spans: Dict[str, Dict] = {}
        self._compiles: Dict[str, int] = {}
        self._captures: Dict[str, int] = {}
        self._aot: Dict[str, str] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a phase.  Nested spans build ``outer/inner`` paths."""
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with _annotation(path):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            s = self._spans.setdefault(
                path, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += dt
            s["max_s"] = max(s["max_s"], dt)

    def record_compile(self, key: str) -> None:
        """Note a step-cache miss at a policy point (a step built)."""
        self._compiles[key] = self._compiles.get(key, 0) + 1

    def record_capture(self, key: str) -> None:
        """Note a CUDA graph captured for a runner's step (its first use
        on the card, or an ahead-of-time capture)."""
        self._captures[key] = self._captures.get(key, 0) + 1

    def captures(self) -> Dict[str, int]:
        return dict(self._captures)

    def record_aot(self, key: str, how: str = "captured") -> None:
        """Note a step prepared ahead of the first chunk under its key
        (``how``: ``"captured"`` for a CUDA graph, ``"eager"`` for a step
        built to run eagerly on the CPU)."""
        self._aot[key] = how

    def aot_installs(self) -> Dict[str, str]:
        return dict(self._aot)

    def compiles(self) -> Dict[str, int]:
        return dict(self._compiles)

    def retraces(self) -> Dict[str, int]:
        """Keys compiled more than once — unexpected retraces: the
        runner's step_cache holds exactly one step per key, so a second
        compile means the cache was dropped and the step re-staged."""
        return {k: n - 1 for k, n in self._compiles.items() if n > 1}

    def retrace_findings(self) -> List[Dict]:
        """The runtime retrace record in static-finding form: one entry
        per key compiled more than once, shaped like a
        ``repro.analysis`` finding payload (the recompile-hazard pass
        merges these with its static probe, so a runtime-observed retrace
        and a statically-proven under-keyed cache land in one report)."""
        return [{"severity": "error", "code": "runtime-retrace",
                 "message": (f"staging key {k!r} compiled {n + 1} times — "
                             "the step cache was dropped or under-keyed"),
                 "provenance": k}
                for k, n in sorted(self.retraces().items())]

    def span_report(self) -> Dict[str, Dict]:
        return {k: dict(v) for k, v in sorted(self._spans.items())}

    def compile_report(self) -> Dict:
        return {"counts": self.compiles(), "retraces": self.retraces(),
                "aot_installs": self.aot_installs()}

    def reset(self) -> None:
        self._spans.clear()
        self._compiles.clear()
        self._captures.clear()
        self._aot.clear()
        self._stack.clear()
