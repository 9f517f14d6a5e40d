"""The comparison catches a broken program: with the timed path broken
underneath, a whole run (set-up, window, comparison) on the CPU at a small
size reports ``correct`` false, once for each fault the cell can have; and
the control (the reference in bfloat16) fails where the program passes."""
import time

import pytest
import torch

from conftest import CELLS
from tiltbench import harness
from repro_torch.engine import Runner
from repro_torch.engine import runner as runner_mod


def _run(cell):
    return harness.run_cell(cell, 2**31 + 21, 1.0, False,
                            time.perf_counter(), device="cpu", **CELLS[cell])


def _wrap_step(monkeypatch, change):
    orig = Runner.step

    def step(self, chunks):
        out = orig(self, chunks)
        return out.replace(value=out.value.clone(),
                           valid=change(out.value, out.valid.clone()))
    monkeypatch.setattr(Runner, "step", step)


# The state carried from chunk to chunk (the tails) never moves on.  The
# ysb query's tumbling windows read no tail, so it cannot have this fault.
@pytest.mark.parametrize("cell", ["fraud-quiet", "fraud-busy",
                                  "fraud-quiet-rate"])
def test_state_left_unchanged_is_caught(cell, monkeypatch):
    monkeypatch.setattr(runner_mod._Work, "shift", lambda self: None)
    out = _run(cell)
    assert out["result"]["correct"] is False


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_half_of_the_keys_left_out_is_caught(cell, monkeypatch):
    def change(value, valid):
        valid[valid.shape[0] // 2:] = False
        return valid
    _wrap_step(monkeypatch, change)
    assert _run(cell)["result"]["correct"] is False


# The first answer of each chunk is moved by the largest input value of
# the chunk: a change the size of a transaction, or of a count.
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_answer_altered_where_it_is_produced_is_caught(cell, monkeypatch):
    orig = Runner.step

    def step(self, chunks):
        out = orig(self, chunks)
        value = out.value.clone()
        hit = out.valid.reshape(-1).nonzero()
        if len(hit):
            v = chunks["in"].value
            big = max(float(x.max()) for x in
                      (v.values() if isinstance(v, dict) else [v]))
            value.view(-1)[hit[0, 0]] += big
        return out.replace(value=value)
    monkeypatch.setattr(Runner, "step", step)
    assert _run(cell)["result"]["correct"] is False


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_fails_where_the_program_passes(cell):
    cell_ = harness.load_cell(cell, False, **CELLS[cell])
    ses = harness.Session(cell_, "cpu")
    ses.load(2**31 + 33)
    keep = harness.Keep(1000, 1)
    ses.window(0.3, keep)
    kept = keep.chunks()
    _, failed = ses.compare(kept)
    assert failed == 0
    _, failed = ses.compare(kept, outputs=lambda ref, prev, cur, p:
                            ref.evaluate(prev, cur, p, torch.bfloat16))
    assert failed == len(kept)
