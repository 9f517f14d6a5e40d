"""The ``qrs`` app (Pan-Tompkins QRS detection with the published filters)
against the benchmark's plain reference, ``tiltbench/reference/qrs.py``,
and the runner's gauge of the lookback each unit evaluates again.

* Keyed, through the chunked ``Runner`` (dense body), chunk by chunk: the
  lookback (473 ticks) crosses every chunk boundary (a chunk is 512 ticks)
  and several partitions (128 ticks).  The first chunk is held against the
  reference with nothing before it: ticks before the stream hold no
  sample, in the program and in the reference alike.
* Unkeyed, through ``compile_query`` and ``partition_run``.
* On seeded ADC codes (integers) and on float samples, each within the
  benchmark cell's own limit; and on codes whose baseline sits hundreds of
  codes off zero, at the cell's own partition (a unit window of 8665
  ticks), where a window sum taken as a difference of float32 prefix sums
  would round far past the limit.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch.core import compile as qc  # noqa: E402
from repro_torch.core.parallel import partition_run  # noqa: E402
from repro_torch.data import apps  # noqa: E402
from repro_torch.engine import ExecPolicy, Runner  # noqa: E402
from tiltbench.reference import qrs as ref  # noqa: E402

CONFIG = json.loads((ROOT / "tiltbench" / "configs"
                     / "qrs-mitbih-96.json").read_text())
PARAMS = CONFIG["reference"]["params"]
LIMIT = CONFIG["limits"]["qrs_err"]
OUT_LEN, SEGS, CHUNKS = 128, 4, 4


def _data(kind, K, T, seed):
    """``(K, T)`` samples: the app's ADC codes, or floats of a like
    spread."""
    if kind == "codes":
        return apps.make_keyed_app("qrs").make_keyed_input(K, T, seed)[
            "in"]["value"]
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 300.0, (K, T))


def _chunk(x):
    """A reference chunk of ``x (K, T)``: every sample present."""
    v = torch.as_tensor(np.asarray(x, np.float32))
    return {"in": {"value": v,
                   "valid": torch.ones(v.shape, dtype=torch.bool)}}


def _nothing(K, T):
    """What lies before the stream: no sample."""
    return {"in": {"value": torch.zeros(K, T),
                   "valid": torch.zeros(K, T, dtype=torch.bool)}}


def _held(value, valid, prev, cur):
    nums = ref.numbers(value, valid, prev, cur, PARAMS)
    assert nums["qrs_err"] <= LIMIT, nums
    assert nums["flags"] > 0
    return nums


@pytest.mark.parametrize("kind", ["codes", "floats"])
@pytest.mark.parametrize("n_keys", [3, 8])
def test_keyed_runner_matches_the_reference(n_keys, kind):
    step = OUT_LEN * SEGS
    assert step > ref.tail_ticks(PARAMS) > OUT_LEN
    x = _data(kind, n_keys, CHUNKS * step, 11 + n_keys)
    _run_keyed(x, OUT_LEN, SEGS)


def _run_keyed(x, out_len, segs):
    """``x (K, T)`` through the keyed dense ``Runner``, chunk by chunk,
    each chunk held against the reference."""
    n_keys, step = x.shape[0], out_len * segs
    exe = qc.compile_query(apps.make_keyed_app("qrs").query.node, out_len)
    r = Runner(exe, ExecPolicy(keys="vmapped", body="dense"),
               n_keys=n_keys, segs_per_chunk=segs)
    prev = _nothing(n_keys, step)
    for c in range(x.shape[1] // step):
        part = x[:, c * step:(c + 1) * step]
        out = r.step(apps.make_grids(
            {"in": {"value": part, "valid": np.ones(part.shape, bool)}},
            device="cpu", t0=c * step))
        assert out.valid.shape == (n_keys, step)
        cur = _chunk(part)
        _held(out.value, out.valid, prev, cur)
        prev = cur


@pytest.mark.parametrize("baseline", [400, 800])
def test_a_baseline_off_zero_stays_within_the_limit(baseline):
    """A lead's ADC codes offset by ``baseline``, at the cell's partition:
    the two 6-tick sums read a unit window of 8665 ticks whose running
    total reaches 1e8, so a difference of float32 prefix sums would round
    the second sum by up to 8 and move the threshold by about 4e-4 (at
    400) or 8e-4 (at 800) of itself; the block sums stay within the
    window's content."""
    out_len = int(CONFIG["out_len"])
    x = _data("codes", 2, 3 * out_len, 17) + baseline
    _run_keyed(x, out_len, 1)


@pytest.mark.parametrize("kind", ["codes", "floats"])
def test_partition_run_matches_the_reference(kind):
    T = 8 * OUT_LEN
    x = _data(kind, 1, T, 5)
    app = apps.make_app("qrs")
    exe = qc.compile_query(app.query.node, OUT_LEN)
    grids = apps.make_grids(
        {"in": {"value": x[0], "valid": np.ones(T, bool)}}, device="cpu")
    out = partition_run(exe, grids, 0, T // OUT_LEN)
    _held(out.value[None], out.valid[None], _nothing(1, T), _chunk(x))


def test_the_lookback_the_plan_evaluates_is_the_references_tail():
    exe = qc.compile_query(apps.make_keyed_app("qrs").query.node,
                           int(CONFIG["out_len"]))
    g, s = exe.plan.evaluated("in"), exe.input_specs["in"]
    assert g.length - s.core == ref.tail_ticks(PARAMS) == 473


@pytest.mark.parametrize("name", ["ysb", "qrs"])
def test_runner_halo_eval_pct(name):
    """The runner's gauge of the lookback every unit evaluates again: the
    ticks of the evaluated unit window before the unit's core over the
    evaluated window, from the plan; none for ysb's tumbling count."""
    if name == "ysb":
        q, out_len, K, segs = (apps.make_keyed_app("ysb", win=10000)
                               .query.node, 1, 100, 16)
    else:
        q = apps.make_keyed_app("qrs").query.node
        out_len, K, segs = (int(CONFIG[k]) for k in
                            ("out_len", "n_keys", "segs_per_chunk"))
    exe = qc.compile_query(q, out_len)
    r = Runner(exe, ExecPolicy(keys="vmapped"), n_keys=K,
               segs_per_chunk=segs)
    g, s = exe.plan.evaluated("in"), exe.input_specs["in"]
    want = 100.0 * (g.length - s.core) / g.length
    gauge = "runner.halo_eval_pct.in"
    assert r.metrics.snapshot()["gauges"][gauge]["value"] == want
    r.metrics.reset_after_warmup()
    assert r.metrics.snapshot()["gauges"][gauge]["value"] == want
    if name == "ysb":
        assert want == 0.0
    else:
        assert want == 100.0 * 473 / (473 + 8192)
