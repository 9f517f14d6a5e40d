"""The plain references against hand-worked cases, and their control (the
reference in bfloat16) against the float64 reference."""
import statistics

import torch

from tiltbench.reference import fraud, ysb


def _chunk(values, valid):
    return {"in": {"value": torch.tensor([values], dtype=torch.float32),
                   "valid": torch.tensor([valid])}}


def test_fraud_by_hand():
    prev = _chunk([1.0, 2.0, 3.0, 4.0], [True] * 4)
    cur = _chunk([10.0, 2.0, 7.0, 5.0], [True, True, False, True])
    v, m = fraud.evaluate(prev, cur, {"win": 3})
    # tick 0: window [2, 3, 4]; tick 1: [3, 4, 10]; tick 3: [10, 2] (7 has
    # no event)
    windows = {0: [2, 3, 4], 1: [3, 4, 10], 3: [10, 2]}
    for t, w in windows.items():
        thr = statistics.fmean(w) + 3 * statistics.pstdev(w)
        x = cur["in"]["value"][0, t].item()
        assert bool(m[0, t]) == (x > thr)
        if x > thr:
            assert abs(v[0, t].item() - (x - thr)) < 1e-9
    assert not bool(m[0, 2])
    assert bool(m[0, 0]) and not bool(m[0, 1]) and not bool(m[0, 3])


def test_fraud_empty_window_has_no_answer():
    prev = _chunk([0.0] * 4, [False] * 4)
    cur = _chunk([5.0, 9.0, 0.0, 0.0], [True, True, False, False])
    v, m = fraud.evaluate(prev, cur, {"win": 3})
    # tick 0: empty window; tick 1: one event, sigma 0, thr = 5
    assert m.tolist() == [[False, True, False, False]]
    assert v[0, 1].item() == 4.0


def test_fraud_numbers():
    prev = _chunk([1.0, 2.0, 3.0, 4.0], [True] * 4)
    cur = _chunk([10.0, 2.0, 7.0, 5.0], [True, True, False, True])
    v, m = fraud.evaluate(prev, cur, {"win": 3})
    assert fraud.numbers(v, m, prev, cur, {"win": 3}) == {"thr_err": 0.0,
                                                          "flags": 1}
    thr0 = 3 + 3 * statistics.pstdev([2, 3, 4])
    got = fraud.numbers(v + 0.5, m, prev, cur, {"win": 3})
    assert abs(got["thr_err"] - 0.5 / thr0) < 1e-9
    drop = fraud.numbers(v, m & False, prev, cur, {"win": 3})
    assert abs(drop["thr_err"] - (10 - thr0) / thr0) < 1e-9
    stray = m.clone()
    stray[0, 2] = True          # an answer at a tick with no event
    assert fraud.numbers(v, stray, prev, cur, {"win": 3})["thr_err"] == \
        float("inf")


def test_ysb_by_hand():
    cur = {"in": {"value": {"etype": torch.tensor([[1., 0, 1, 1, 2, 2, 0, 2]])},
                  "valid": torch.tensor([[True] * 8])}}
    v, m = ysb.evaluate(None, cur, {"win": 4, "view": 1.0})
    assert v.tolist() == [[3.0, 0.0]] and m.tolist() == [[True, False]]
    assert ysb.numbers(v, m, None, cur, {"win": 4, "view": 1.0}) == {
        "count_err": 0.0, "windows": 2}
    assert ysb.numbers(v + 1, m, None, cur, {"win": 4, "view": 1.0})[
        "count_err"] == 1.0
    assert ysb.numbers(v, ~m, None, cur, {"win": 4, "view": 1.0})[
        "count_err"] == float("inf")


def test_the_tails_the_queries_read_back():
    # fraud's first tick reads the window [t - 1000, t - 1]; a tumbling
    # window reads nothing before its chunk
    assert fraud.tail_ticks({"win": 1000}) == 1000
    assert ysb.tail_ticks({"win": 10000, "view": 1.0}) == 0


def test_the_controls_fail_the_limits():
    g = torch.Generator().manual_seed(3)
    K, T = 64, 2048
    x = torch.empty(2, K, T).log_normal_(3.0, 1.0, generator=g)
    chunks = [{"in": {"value": x[i], "valid": torch.ones(K, T, dtype=bool)}}
              for i in range(2)]
    p = {"win": 1000}
    v, m = fraud.evaluate(*chunks, p, torch.bfloat16)
    assert fraud.numbers(v, m, *chunks, p)["thr_err"] > 1e-2
    v, m = fraud.evaluate(*chunks, p, torch.float32)
    assert fraud.numbers(v, m, *chunks, p)["thr_err"] < 1e-3
    et = torch.randint(0, 3, (K, 160000), generator=g).float()
    cur = {"in": {"value": {"etype": et}, "valid": torch.ones(K, 160000,
                                                             dtype=bool)}}
    q = {"win": 10000, "view": 1.0}
    v, m = ysb.evaluate(None, cur, q, torch.bfloat16)
    assert ysb.numbers(v, m, None, cur, q)["count_err"] > 0
