"""Shared set-up of the benchmark's own tests: the port's sources and the
benchmark on the import path, and the cells the tests run at a size the
CPU holds."""
import json
import sys
from pathlib import Path

import pytest
import torch

# several test processes share the cores: one thread each keeps them fast
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"
TEST_BENCH = json.loads((DATA / "bench.json").read_text())
_TEST = {"bench": TEST_BENCH, "traffic_dir": DATA / "traffic"}

# The keyword arguments of ``harness.load_cell``/``run_cell`` for each
# cell: ``ysb100`` of BENCHMARK.json at a small size, and the test data's
# fraud cells (``data/bench.json``).  Every chunk of a window is compared.
CELLS = {
    "ysb100": {"overrides": {"config": {"n_keys": 4},
                             "traffic": {"ring_chunks": 3,
                                         "warmup_chunks": 2},
                             "compare_chunks": 1000}},
    "fraud-quiet": dict(_TEST, overrides={"compare_chunks": 1000}),
    "fraud-busy": dict(_TEST, overrides={"config": {"n_keys": 64},
                                         "compare_chunks": 1000}),
    "fraud-quiet-rate": dict(_TEST, overrides={
        "traffic": {"loop": "open", "rate_keyticks_per_s": 5.0e7},
        "compare_chunks": 1000}),
}


def bench_of(cell: str) -> dict:
    """The benchmark file that names ``cell``."""
    if "bench" in CELLS[cell]:
        return CELLS[cell]["bench"]
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and the CUDA toolkit")
    return torch.device("cuda")
