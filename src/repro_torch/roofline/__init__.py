"""Roofline terms of the dry-run's traced steps (port of
``repro.roofline``): ``analysis`` (the trace, the H100's constants and the
terms), ``recompute`` (the terms again from saved traces) and ``report``
(the markdown tables)."""
