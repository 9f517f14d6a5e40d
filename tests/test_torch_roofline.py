"""The port's roofline terms (``repro_torch.roofline``), mirroring
``tests/test_roofline.py``, on the CPU.

The reference derives its collective bytes from HLO text; the port from
the collectives its trace recorded.  The same collectives (the
reference's ``HLO_FLAT``: an all-reduce of f32[1024] over groups of 16
and an all-gather of f32[1024] over groups of 4) give the same bytes on
the wire, and with the reference's hardware constants passed in the same
roofline, key for key.  ``HW()`` holds the H100's.
"""
import json

import pytest
import torch
from test_roofline import HLO_FLAT

from repro.roofline import analysis as ref
from repro_torch.roofline import analysis as A
from repro_torch.roofline import recompute, report

FLAT = [{"kind": "all-reduce", "bytes": 4096, "group": 16, "count": 1},
        {"kind": "all-gather", "bytes": 4096, "group": 4, "count": 1}]
REF_HW = A.HW(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
              hbm_bytes=16e9)


def test_collective_bytes_ring_factors_match_the_reference():
    got = A.collective_bytes(FLAT)
    want = ref.collective_bytes(HLO_FLAT)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12), k
    assert got["all-reduce"] == pytest.approx(2 * 4096 * 15 / 16)
    assert got["all-gather"] == pytest.approx(4096 * 3 / 4)


def test_ring_factors_of_every_kind():
    """reduce-scatter: out × (g-1); all-to-all: size × (g-1)/g; a
    collective-permute its size; counts multiply; a group of one rank
    moves nothing."""
    recs = [{"kind": "reduce-scatter", "bytes": 100, "group": 4,
             "count": 2},
            {"kind": "all-to-all", "bytes": 800, "group": 8, "count": 1},
            {"kind": "collective-permute", "bytes": 64, "group": 2,
             "count": 3},
            {"kind": "all-reduce", "bytes": 1e6, "group": 1, "count": 5}]
    got = A.collective_bytes(recs)
    assert got["reduce-scatter"] == 2 * 100 * 3
    assert got["all-to-all"] == 800 * 7 / 8
    assert got["collective-permute"] == 3 * 64
    assert got["all-reduce"] == 0
    assert got["total"] == 600 + 700 + 192


def test_roofline_with_the_reference_constants_equals_the_reference():
    cost = {"flops": 197e12, "bytes accessed": 819e9 * 2}
    want = ref.roofline(cost, HLO_FLAT, model_flops_per_device=98.5e12,
                        hw=ref.HW()).to_dict()
    got = A.roofline(cost, FLAT, 98.5e12, hw=REF_HW).to_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k] == pytest.approx(v), k
        elif isinstance(v, str):
            assert got[k] == v, k
        else:
            assert got[k] == pytest.approx(v, rel=1e-12), k
    rep = A.roofline(cost, FLAT, 98.5e12, hw=REF_HW)
    assert rep.dominant == "memory"
    assert rep.roofline_fraction == pytest.approx(0.25)


def test_hw_holds_the_h100_constants():
    hw = A.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 50e9, 80e9)
    rep = A.roofline({"flops": 989e12, "bytes accessed": 3.35e12 * 3},
                     FLAT, 989e12 / 2)
    assert rep.compute_s == pytest.approx(1.0)
    assert rep.memory_s == pytest.approx(3.0)
    assert rep.dominant == "memory"
    assert rep.roofline_fraction == pytest.approx(0.5 / 3.0)


def test_step_trace_counts_flops_bytes_and_peak_of_the_local_program():
    """A matmul's 2·M·N·K FLOPs, operands read once and the output
    written once, and the peak of the live bytes created in the step."""
    a, b = torch.randn(8, 16), torch.randn(16, 32)
    with A.StepTrace() as tr:
        c = a @ b
        d = torch.relu(c)
        del c
        e = d.sum()
    assert tr.flops == 2 * 8 * 16 * 32
    assert tr.bytes == (4 * (8 * 16 + 16 * 32 + 8 * 32)   # mm
                        + 4 * 2 * 8 * 32                  # relu
                        + 4 * (8 * 32 + 1))                # sum
    assert tr.peak_bytes == 4 * (8 * 32 * 2)   # c and d at once
    assert tr.live == 4 * (8 * 32 + 1)
    assert float(e) == float(d.sum()) and tr.records() == []


def _cells():
    roof = A.roofline({"flops": 1e15, "bytes accessed": 1e13}, FLAT,
                      2e14).to_dict()
    return [
        {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "single",
         "device_type": "cuda", "ok": True, "devices": 256, "per_device_bytes": 14.3e9,
         "lower_s": 73.4, "roofline": roof, "cost": {
             "flops": 1e15, "bytes accessed": 1e13}, "coll": FLAT},
        {"arch": "dbrx-132b", "shape": "train_4k", "mesh": "multi",
         "device_type": "cpu", "ok": True, "devices": 512, "per_device_bytes": 134e9,
         "lower_s": 127.0, "roofline": roof, "cost": {
             "flops": 1e15, "bytes accessed": 1e13}, "coll": FLAT},
        {"arch": "rwkv6-7b", "shape": "train_4k", "mesh": "single",
         "device_type": "cuda", "ok": False, "error": "trace timeout"}]


def test_report_renders_fixture_cells(tmp_path):
    cells = _cells()
    summary = report.dryrun_summary(cells)
    assert "Traced OK: **2/3** runs (1 single-pod + 1 multi-pod)" in summary
    assert "1/2 fit in 80 GB per device" in summary
    assert ("| qwen3-1.7b | train_4k | single | cuda | 256 | 14.30 | ✓ "
            "| 73.4 |") in summary
    assert "| dbrx-132b | train_4k | multi | cpu | 512 | 134.00 | ✗ |" in (
        summary)
    assert ("| rwkv6-7b | train_4k | single | cuda | - | - | FAIL: trace "
            "timeout") in summary
    table = report.roofline_table(cells)
    assert table.count("**memory**") == 2
    assert "| qwen3-1.7b | train_4k | cuda | " in table
    assert "| dbrx-132b | train_4k | cpu | " in table
    for c in cells:
        (tmp_path / f"{c['arch']}_{c['shape']}_{c['mesh']}.json").write_text(
            json.dumps(c))
    doc = tmp_path / "doc.md"
    doc.write_text("a\n<!-- DRYRUN_SUMMARY -->\nb\n<!-- ROOFLINE_TABLE -->\n")
    report.main(str(tmp_path), str(doc))
    text = doc.read_text()
    loaded = report.load(str(tmp_path))
    assert len(loaded) == 3 and "<!--" not in text
    assert report.dryrun_summary(loaded) in text
    assert report.roofline_table(loaded) in text


def test_recompute_replays_saved_traces(tmp_path):
    """A cell's roofline recomputed from its saved trace (here with the
    all-gather dropped), and from its own records where none is saved."""
    out, traces = tmp_path / "out", tmp_path / "traces"
    out.mkdir()
    traces.mkdir()
    cells = _cells()[:2]
    for c in cells:
        (out / f"{c['arch']}_{c['shape']}_{c['mesh']}.json").write_text(
            json.dumps(c))
    (traces / "qwen3-1.7b_train_4k_single.json").write_text(json.dumps(
        {"cost": cells[0]["cost"], "collectives": FLAT[:1]}))
    recompute.main(str(out), str(traces))
    q = json.loads((out / "qwen3-1.7b_train_4k_single.json").read_text())
    d = json.loads((out / "dbrx-132b_train_4k_multi.json").read_text())
    assert q["roofline"]["coll_breakdown"] == pytest.approx(
        {"all-reduce": 2 * 4096 * 15 / 16})
    assert d["roofline"] == cells[1]["roofline"]
