"""The traffic generator: deterministic from its seed, and the activity and
fields each mix asks for."""
import json
from pathlib import Path

import pytest
import torch

from conftest import DATA
from tiltbench import gen

# the benchmark's mixes, and the test data's
DIRS = {"views": Path(__file__).resolve().parents[1] / "traffic",
        "quiet": DATA / "traffic", "busy": DATA / "traffic"}


def _mix(name):
    return json.loads((DIRS[name] / f"{name}.json").read_text())


def _flat(ring):
    out = []
    for chunk in ring:
        for name in sorted(chunk):
            v = chunk[name]["value"]
            leaves = [v[k] for k in sorted(v)] if isinstance(v, dict) else [v]
            out += leaves + [chunk[name]["valid"]]
    return out


@pytest.mark.parametrize("mix", sorted(DIRS))
def test_same_seed_same_ring_other_seed_other_ring(mix):
    tr = dict(_mix(mix), ring_chunks=3)
    K, T = (8, 20000) if mix == "views" else (64, 1024)
    a = _flat(gen.make_ring(tr, K, T, 2**31 + 11, "cpu"))
    b = _flat(gen.make_ring(tr, K, T, 2**31 + 11, "cpu"))
    c = _flat(gen.make_ring(tr, K, T, 2**31 + 12, "cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_quiet_activity_is_the_same_amount_on_every_seed():
    tr = dict(_mix("quiet"), ring_chunks=4)
    K, T = 500, 1024
    for seed in (1, 2, 3):
        for chunk in gen.make_ring(tr, K, T, seed, "cpu"):
            m = chunk["in"]["valid"]
            per_key = m.sum(-1)
            assert int((per_key > 0).sum()) == round(K * 0.02)
            assert set(per_key.unique().tolist()) == {0, 128}
            # one run of consecutive ticks a key
            starts = (m[:, 1:] & ~m[:, :-1]).sum(-1) + m[:, 0].long()
            assert int(starts.max()) == 1
            assert bool((chunk["in"]["value"][~m] == 0).all())
            assert bool((chunk["in"]["value"][m] > 0).all())


def test_busy_and_views_fields():
    tr = dict(_mix("busy"), ring_chunks=2)
    m = gen.make_ring(tr, 256, 1024, 5, "cpu")[0]["in"]["valid"]
    assert abs(float(m.float().mean()) - 0.7) < 0.01
    tr = dict(_mix("views"), ring_chunks=2)
    ch = gen.make_ring(tr, 6, 30000, 5, "cpu")[1]["in"]
    assert set(ch["value"]) == {"etype"}
    et = ch["value"]["etype"]
    assert bool(ch["valid"].all())
    assert set(et.unique().tolist()) == {0.0, 1.0, 2.0}
    assert abs(float((et == 1.0).float().mean()) - 1 / 3) < 0.01
    assert gen.chunk_keyticks(100, 160000) == 16_000_000
