"""All ten SMOKE configurations at f32 (``dtype`` and ``param_dtype``
float32): the port's train loss within 1e-5 relative of the jitted
reference's, and every gradient leaf within 1e-4 of that leaf's largest
magnitude.  The machinery and the bf16 half are in
``tests/test_torch_train_grads.py``."""
import pytest

from test_torch_train_grads import ARCHS, check


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_f32(arch):
    check(arch, "float32")
