"""The ``qrs96`` cell on the CPU at a small size, its plain reference
(``reference/qrs.py``) and the ``sliding_halo_pct`` reader."""
import json
import time

import pytest
import torch

from conftest import ROOT
from tiltbench import harness
from tiltbench.reference import qrs

OVERRIDES = {"config": {"n_keys": 4, "out_len": 512, "segs_per_chunk": 2},
             "traffic": {"ring_chunks": 3, "warmup_chunks": 2},
             "compare_chunks": 1000}
CONFIG = json.loads((ROOT / "tiltbench" / "configs"
                     / "qrs-mitbih-96.json").read_text())
PARAMS = CONFIG["reference"]["params"]
LIMIT = CONFIG["limits"]["qrs_err"]


def _chunks(K=4, T=2048, seed=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-1024, 1024, (2, K, T), generator=g).float()
    m = torch.ones((K, T), dtype=torch.bool)
    return ({"in": {"value": x[0], "valid": m}},
            {"in": {"value": x[1], "valid": m}})


@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_run_is_correct(trace):
    out = harness.run_cell("qrs96", 2**31 + 11, 0.3, bool(trace),
                           time.perf_counter(), device="cpu",
                           overrides=OVERRIDES)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert 0 < out["checks"]["qrs_err"]["value"] <= LIMIT
    want = ({"step_host_ms.tput", "chunk_roofline_pct", "sliding_halo_pct"}
            if trace else {"keyticks_per_s", "setup_s"})
    assert set(res["metrics"]) == want


def test_the_tail_the_query_reads_back():
    # 5 + 5 (two 6-tick sums), 31 (the 32-tick sum), 4 (the derivative),
    # 29 (the 150 ms integration) and 399 (the 2 s maximum)
    assert qrs.tail_ticks(PARAMS) == 473


def test_numbers_catch_a_threshold_moved_by_1e_3():
    prev, cur = _chunks()
    value, valid = qrs.evaluate(prev, cur, PARAMS)
    assert qrs.numbers(value, valid, prev, cur, PARAMS)["qrs_err"] == 0.0
    moved_v, moved_m = [], []
    for _k0, _k1, e, thr, has in qrs._blocks(prev, cur, PARAMS,
                                             torch.float64):
        v = e - 1e-3 * thr
        moved_v.append(v)
        moved_m.append(has & (v > 0))
    got = qrs.numbers(torch.cat(moved_v), torch.cat(moved_m), prev, cur,
                      PARAMS)
    assert got["qrs_err"] > LIMIT
    assert abs(got["qrs_err"] - 1e-3) < 1e-9
    stray = valid.clone()
    stray[0, 0] = True
    nothing = {"in": {"value": prev["in"]["value"],
                      "valid": torch.zeros_like(prev["in"]["valid"])}}
    early = qrs.numbers(value, stray, nothing, cur, PARAMS)
    assert early["qrs_err"] == float("inf")
    # a NaN answer at a tick both sides flag
    k, t = valid.nonzero()[0].tolist()
    nan = value.clone()
    nan[k, t] = float("nan")
    assert qrs.numbers(nan, valid, prev, cur, PARAMS)["qrs_err"] == float(
        "inf")


def test_the_bfloat16_control_fails():
    prev, cur = _chunks()
    value, valid = qrs.evaluate(prev, cur, PARAMS, torch.bfloat16)
    assert qrs.numbers(value, valid, prev, cur, PARAMS)["qrs_err"] > LIMIT


def test_sliding_halo_pct_counts_the_lookback_of_the_sliding_rows():
    from repro_torch.core import ir
    cell = harness.load_cell("qrs96", True, OVERRIDES)
    ses = harness.Session(cell, "cpu")
    ses.load(5)
    spec = ses.runner.spec
    units = ses.K * ses.runner.n_segs
    core = OVERRIDES["config"]["out_len"]
    # by hand: each window (the two 6-tick sums, the 32-tick sum, the
    # integration, the 2 s maximum) runs on sliding_assoc over its
    # argument's grid, two channels (value and count, or value and
    # validity) of every unit
    lengths = [spec.plan.plan_of(n.args[0]).length
               for n in ir.topo_order(spec.root) if isinstance(n, ir.Reduce)]
    assert len(lengths) == 5
    want = 100.0 * sum(T - core for T in lengths) / sum(lengths)
    ctx = harness.Ctx(loop="closed", setup_s=0.0, chunks=1, window_s=1.0,
                      keyticks_per_chunk=ses.kt, latencies_s=[],
                      step_host_s=0.0, chunk_bytes=1, sparse=False,
                      units=units, shapes=ses.shapes)
    assert abs(harness._reader("sliding_halo_pct")(ctx) - want) < 1e-9
    ctx.shapes = harness.ShapeLog()
    assert harness._reader("sliding_halo_pct")(ctx) is None
    ctx.shapes = None
    assert harness._reader("sliding_halo_pct")(ctx) is None
