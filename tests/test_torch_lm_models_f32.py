"""All ten SMOKE configurations at f32 (``dtype`` and ``param_dtype``
float32), the port against the reference within 1e-4: the full forward,
the prefill's logits and caches, and 8 decode steps with the caches after
them.  The machinery and the bf16 half are in
``tests/test_torch_lm_models.py``."""
import pytest

from test_torch_lm_models import (ARCHS, check_decode, check_forward,
                                  check_prefill)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_f32(arch):
    check_forward(arch, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_f32(arch):
    check_prefill(arch, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_f32(arch):
    check_decode(arch, "float32")
