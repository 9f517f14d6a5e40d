"""Entry points (port of ``repro.launch``): device meshes, the sharding
rules, the dry-run, the LM serving loop and the LM training loop."""
