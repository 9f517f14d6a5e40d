"""On the card: the benchmark's cell runs through ``run.py`` and is
correct, the control fails there at the cell's own size, and the test
data's fraud cells (the sparse body, the open loop) run correct through
the harness.  Each test carries the ``cuda`` marker and skips where there
is no card."""
import json
import subprocess
import sys
import time

import pytest

from conftest import CELLS, ROOT
from tiltbench import harness

BENCH_CELLS = [w["name"] for w in
               json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_cell_runs_correct_on_the_card(cell, cuda):
    r = subprocess.run([sys.executable, "tiltbench/run.py", "--workload",
                        cell, "--seed", str(2**31 + 7), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_control_fails_at_the_cells_size(cell, cuda):
    r = subprocess.run([sys.executable, "tiltbench/readings.py",
                        "--workload", cell, "--seeds", "5", "--seconds",
                        "0.5", "--control"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.splitlines()[-1])
    assert line["failed"] == 0 and line["control_failed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["fraud-quiet", "fraud-busy",
                                  "fraud-quiet-rate"])
def test_the_test_cells_run_correct_on_the_card(cell, trace, cuda):
    from repro_torch.kernels.build import library
    library.load()
    out = harness.run_cell(cell, 2**31 + 9, 1.0, bool(trace),
                           time.perf_counter(), device="cuda", **CELLS[cell])
    res = out["result"]
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0 and res["metrics"]
