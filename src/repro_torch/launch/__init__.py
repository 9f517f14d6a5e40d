"""Entry points (port of ``repro.launch``): device meshes, the LM
serving loop and the LM training loop."""
