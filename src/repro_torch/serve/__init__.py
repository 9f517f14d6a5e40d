"""Low-latency serving on the policy runner (port of ``repro.serve``).

Three pieces, composable but separable:

* :mod:`repro_torch.serve.aot` — every step a served runner runs, prepared
  ahead of the first chunk (captured as a CUDA graph on the card), with a
  persisted capture manifest per step so a fresh process rebuilds its
  runner without planning.  A CUDA graph cannot be serialized, so unlike
  the reference's executables the graphs are captured anew in every
  process.
* :mod:`repro_torch.serve.ring` — fixed-capacity FIFO admission ring with
  explicit shed policies and ``serve.*`` telemetry.
* :mod:`repro_torch.serve.loop` — :class:`ServeLoop` (double-buffered
  chunk path through pinned memory and a side CUDA stream + ring-fed
  event path over :class:`repro_torch.ingest.IngestRunner`) and
  :func:`build_service`, the one-call constructor wiring the persisted
  plan and capture caches.

``python -m repro_torch.serve --smoke`` runs a small end-to-end serving
loop and gates it: the steady tail under PyTorch's sync debug mode, no
capture after warm-up.
"""
from .aot import (ExecutableCache, aot_capture, capture_manifest,
                  step_fingerprint)
from .loop import (ServeLoop, body_spec_from_artifact, build_service,
                   plan_artifact_of)
from .ring import AdmissionRing, Backpressure, RingEntry

__all__ = ["AdmissionRing", "Backpressure", "ExecutableCache", "RingEntry",
           "ServeLoop", "aot_capture", "body_spec_from_artifact",
           "build_service", "capture_manifest", "plan_artifact_of",
           "step_fingerprint"]
