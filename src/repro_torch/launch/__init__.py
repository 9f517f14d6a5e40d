"""Device meshes for the multi-device execution paths (port of
``repro.launch``'s mesh module)."""
