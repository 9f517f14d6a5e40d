"""Model configurations of the ten architectures (the port's own copy of
``repro.configs``): ``get_config(arch_id, smoke=False)``, ``registry()``.
"""
from .base import SHAPES, ModelConfig, Shape, get_config, registry

__all__ = ["ModelConfig", "SHAPES", "Shape", "get_config", "registry"]
