"""The port's checkpoints (``repro_torch.train.checkpoint``): mirrors of
the checkpoint tests of ``tests/test_checkpoint_train.py`` (roundtrip and
keep-last-K, no partial directories, the four corrupt-checkpoint
fallbacks), the on-disk format across packages (the reference's ``save``
read by the port's ``restore`` bit for bit, and the reverse, over f32,
bf16, f8-e4m3, int32 and nested leaves), and a restore written into live
tensors."""
import json
import os
import tempfile

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as rck
from repro_torch.train import checkpoint as ck


def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(6.0).reshape(2, 3),
                "nest": {"b": torch.ones(4, dtype=torch.int32)}}
        mgr = ck.CheckpointManager(d, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, tree, extra={"s": s}, blocking=True)
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                       if x.startswith("step_"))
        assert steps == [3, 4]  # keep-last-2 rotation
        restored, manifest = mgr.restore_latest(device="cpu")
        assert manifest["step"] == 4 and manifest["extra"]["s"] == 4
        np.testing.assert_array_equal(restored["a"].numpy(),
                                      np.arange(6.0).reshape(2, 3))
        assert restored["nest"]["b"].dtype == torch.int32


def test_checkpoint_async_save_lands_after_wait():
    with tempfile.TemporaryDirectory() as d:
        mgr = ck.CheckpointManager(d, keep=2)
        t = torch.arange(5, dtype=torch.float32)
        mgr.save(1, {"t": t}, blocking=False)
        t.add_(100)            # the host copy was taken before the write
        mgr.wait()
        restored, _ = ck.restore(d, device="cpu")
        np.testing.assert_array_equal(restored["t"].numpy(), np.arange(5.0))


def test_checkpoint_atomic_no_partial_dirs():
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 7, {"x": torch.zeros(3)})
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
        assert ck.latest_step(d) == 7


def test_restore_falls_back_past_corrupt_latest():
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, {"x": torch.arange(3.0)}, extra={"s": 1})
        ck.save(d, 2, {"x": torch.arange(3.0) * 2}, extra={"s": 2})
        npz = os.path.join(d, "step_2", "arrays.npz")
        with open(npz, "r+b") as f:
            f.truncate(os.path.getsize(npz) // 2)
        assert ck.latest_step(d) == 2
        with pytest.warns(RuntimeWarning, match="step_2"):
            tree, manifest = ck.restore(d, device="cpu")
        assert manifest["step"] == 1 and manifest["extra"]["s"] == 1
        np.testing.assert_array_equal(tree["x"].numpy(), np.arange(3.0))


def test_restore_falls_back_past_corrupt_manifest():
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, {"x": torch.ones(2)}, extra={"s": 1})
        ck.save(d, 2, {"x": torch.zeros(2)}, extra={"s": 2})
        with open(os.path.join(d, "step_2", "manifest.json"), "w") as f:
            f.write('{"step": 2, "keys"')  # truncated json
        with pytest.warns(RuntimeWarning):
            _, manifest = ck.restore(d, device="cpu")
        assert manifest["step"] == 1


def test_restore_explicit_step_still_raises_on_corruption():
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, {"x": torch.ones(2)})
        ck.save(d, 2, {"x": torch.zeros(2)})
        npz = os.path.join(d, "step_2", "arrays.npz")
        with open(npz, "r+b") as f:
            f.truncate(8)
        with pytest.raises(Exception):
            ck.restore(d, step=2, device="cpu")


def test_restore_all_corrupt_raises():
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, {"x": torch.ones(2)})
        npz = os.path.join(d, "step_1", "arrays.npz")
        with open(npz, "r+b") as f:
            f.truncate(4)
        with pytest.raises(RuntimeError, match="no restorable checkpoint"):
            ck.restore(d, device="cpu")


def test_restore_into_writes_the_live_tensors_and_nothing_on_corruption():
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 1, {"p": {"w": torch.full((2, 2), 3.0,
                                             dtype=torch.bfloat16)},
                       "step": torch.tensor(5, dtype=torch.int32)})
        live = {"p": {"w": torch.zeros((2, 2), dtype=torch.bfloat16)},
                "step": torch.zeros((), dtype=torch.int32)}
        ptr = live["p"]["w"].data_ptr()
        out, manifest = ck.restore(d, into=live)
        assert out is live and manifest["step"] == 1
        assert live["p"]["w"].data_ptr() == ptr
        assert float(live["p"]["w"][0, 0]) == 3.0 and int(live["step"]) == 5
        with pytest.raises(ValueError):
            ck.restore(d, into={"p": {"w": torch.zeros(3)},
                                "step": torch.zeros((), dtype=torch.int32)})
        npz = os.path.join(d, "step_1", "arrays.npz")
        with open(npz, "r+b") as f:
            f.truncate(8)
        live["p"]["w"].fill_(7.0)
        with pytest.raises(Exception):
            ck.restore(d, step=1, into=live)
        assert float(live["p"]["w"][0, 0]) == 7.0


# ---------------------------------------------------------------------------
# the on-disk format across packages
# ---------------------------------------------------------------------------

def _mixed(seed: int):
    """One tree of f32, bf16, f8-e4m3, int32 and nested leaves, as numpy
    (ml_dtypes for the exotic ones), with subnormals, NaN and -0.0."""
    rng = np.random.default_rng(seed)
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    f32[0, :3] = [np.nan, -0.0, 1e-40]
    return {"f32": f32,
            "bf16": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
            "f8": (rng.normal(size=(2, 3)) * 4).astype(
                ml_dtypes.float8_e4m3fn),
            "nest": {"i32": rng.integers(-9, 9, (4,)).astype(np.int32),
                     "deep": {"s": np.asarray(7, np.int32)}}}


def _bits(a) -> np.ndarray:
    """The raw bits of an array or tensor, as unsigned integers."""
    if torch.is_tensor(a):
        t = a.detach().cpu().contiguous()
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            t.element_size()]
        return t.view(width).numpy().view(f"u{t.element_size()}")
    a = np.asarray(a)
    return np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{pre}/{k}"))
        return out
    return {pre: tree}


_NAMES = {"f32": "float32", "bf16": "bfloat16", "f8": "float8_e4m3fn",
          "nest/i32": "int32", "nest/deep/s": "int32"}


def test_reference_checkpoint_restores_in_the_port_bit_for_bit():
    want = _mixed(0)
    with tempfile.TemporaryDirectory() as d:
        rck.save(d, 3, {k: jnp.asarray(v) for k, v in want.items()
                        if k != "nest"} | {"nest": want["nest"]},
                 extra={"pipeline": {"step": 3}})
        got, manifest = ck.restore(d, device="cpu")
    assert manifest["extra"] == {"pipeline": {"step": 3}}
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert str(g[k].dtype) == "torch." + _NAMES[k[1:]], k
        assert tuple(g[k].shape) == w[k].shape, k
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=k)


def test_port_checkpoint_restores_in_the_reference_bit_for_bit():
    want = _mixed(1)
    port = {"f32": torch.from_numpy(want["f32"]),
            "bf16": torch.from_numpy(want["bf16"].view(np.int16)).view(
                torch.bfloat16),
            "f8": torch.from_numpy(want["f8"].view(np.uint8)).view(
                torch.float8_e4m3fn),
            "nest": {"i32": torch.from_numpy(want["nest"]["i32"]),
                     "deep": {"s": torch.tensor(7, dtype=torch.int32)}}}
    with tempfile.TemporaryDirectory() as d:
        ck.save(d, 5, port, extra={"s": 5})
        got, manifest = rck.restore(d)
        with open(os.path.join(d, "step_5", "manifest.json")) as f:
            dtypes = json.load(f)["dtypes"]
    assert dtypes == _NAMES and manifest["extra"] == {"s": 5}
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        ga = np.asarray(g[k])
        assert ga.dtype == w[k].dtype and ga.shape == w[k].shape, k
        np.testing.assert_array_equal(_bits(ga), _bits(w[k]), err_msg=k)
