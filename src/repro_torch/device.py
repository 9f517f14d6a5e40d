"""Device resolution for the port's entry points.

Every entry point that turns host data into tensors (``events_to_grid``,
the apps' input helpers, :mod:`repro_torch.convert`) takes a ``device``
argument and resolves it here.  The port runs on CUDA unless the caller
asks for the CPU by name: with no argument and no CUDA device it raises,
and never carries on quietly on the CPU.  The executors
(``compile_query``'s callables, ``partition_run``, ``batch_run``) follow the
device of the tensors they are given.
"""
from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(device=None) -> torch.device:
    """The device to build tensors on: ``cuda`` unless ``device`` says
    otherwise.  Raises ``RuntimeError`` when no device is given and no CUDA
    device exists."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
