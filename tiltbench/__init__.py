"""Benchmark of the PyTorch and CUDA port of TiLT (``repro_torch``): see
``run.py`` and ``harness.py``."""
