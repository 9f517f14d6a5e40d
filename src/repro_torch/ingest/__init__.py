"""Out-of-order ingestion: watermarks, bounded-lateness reorder
buffering, and late-data revision processing (port of
``repro.ingest``).

The execution engine assumes in-order tick grids; this package is the
boundary that makes that assumption true against disordered feeds.
:class:`IngestRunner` wraps a :class:`repro_torch.engine.runner.Runner` with a
:class:`WatermarkTracker` (per-key low-watermark, bounded lateness), one
:class:`ReorderBuffer` per query input (static-shape eager rasterization
with deterministic overlap precedence), and a lateness policy
(``buffer | revise | drop``) for events behind the sealed frontier —
``revise`` re-runs only the ChangePlan-dilated output segments through
the runner's sparse revision path and emits versioned
:class:`Correction` rows.
"""
from .pipeline import Correction, IngestRunner, SealedChunk
from .reorder import ReorderBuffer
from .watermark import WatermarkTracker

__all__ = ["Correction", "IngestRunner", "ReorderBuffer", "SealedChunk",
           "WatermarkTracker"]
