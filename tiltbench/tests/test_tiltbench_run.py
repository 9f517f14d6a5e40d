"""Whole runs on the CPU at small sizes: the result's keys, correctness on
every cell, and the guards (no card, no port, forbidden imports)."""
import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from conftest import CELLS, ROOT, bench_of
from tiltbench import harness

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_small_run_is_correct_and_has_the_result_keys(cell, trace):
    out = harness.run_cell(cell, 2**31 + 5, 0.3, bool(trace),
                           time.perf_counter(), device="cpu",
                           **CELLS[cell])
    res = out["result"]
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "checks"
    assert set(res) <= set(RESULT_KEYS) | {"breakdown", "checks"}
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    bench = bench_of(cell)
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in bench[kind]
               if cell in m.get("workloads", [cell])}
    assert res["metrics"]
    for name, m in res["metrics"].items():
        assert allowed[name] == m["unit"] and m["value"] == m["value"]
    if not trace:
        assert set(res["metrics"]) == set(allowed)
    json.dumps(res)


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "tiltbench/run.py", "--workload",
                        "ysb100", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_without_the_port_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tiltbench", tmp_path / "tiltbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "tiltbench/run.py", "--workload",
                        "ysb100", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_a_run_loads_neither_jax_nor_the_reference_package():
    code = (
        "import sys, time; sys.path[:0] = ['src', '.']\n"
        "from tiltbench import harness\n"
        f"harness.run_cell('ysb100', 3, 0.2, True, time.perf_counter(), "
        f"device='cpu', overrides={CELLS['ysb100']['overrides']!r})\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_modules())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    tops = eval(r.stdout.splitlines()[-2])
    assert "repro_torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)
    assert r.stdout.splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "reprox", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "tiltbench" / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "torch", "typing",
                                          "math"), (path.name, name)


def test_nothing_in_the_benchmark_imports_jax_or_the_reference_package():
    for path in (ROOT / "tiltbench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "repro"), (path, name)
