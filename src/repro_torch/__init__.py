"""PyTorch and CUDA port of the TiLT query path (``repro`` is the JAX
reference).

Layout mirrors the reference: ``core/`` (stream, IR, frontend, fusion,
boundary, halo planning, reductions, planner, evaluator, partitioned and
keyed execution), ``kernels/`` (the CUDA window kernels, their plain
versions and the masked wrappers), ``data/apps.py`` (the benchmark apps),
``convert.py`` (grids across packages) and ``device.py`` (device rule:
CUDA unless the caller asks for the CPU).
"""
