"""The port's multi-hop halo exchange and time-sharded execution
(``repro_torch.core.halo``, ``repro_torch.core.parallel``), as
``tests/test_halo.py`` holds the reference, and against the reference.

Everything here runs in this process on a 1-rank gloo mesh
(``launch.mesh.make_local_mesh(n_data=1, device="cpu")``), which drives
the whole exchange path with every halo tick φ, as the reference's
1-device mesh does; the 8-rank checks live in
``tests/test_torch_multidev.py``.  The planning arithmetic (``hop_count``,
``schedule``, ``exchange_cost``, ``check_single_hop_halo``) is held equal
to the reference's over a grid of ``(halo, core, n)``, and
:func:`halo.exchange` is driven for one rank of eight through a stub
communicator whose neighbours answer each hop from the clean global grid,
while the rank's own copy of the global grid is poisoned outside its core:
the partition it computes is unchanged, so its halo arrived through the
hops and through nothing else.

Data is integer-valued, so every comparison is exact.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import compile as rqc
from repro.core import halo as rhalo
from repro.core.frontend import TStream as RTStream
from repro.core.parallel import (check_single_hop_halo as r_check,
                                 partition_run as r_partition_run,
                                 record_exchange as r_record_exchange,
                                 shard_map_run as r_shard_map_run)
from repro.core.stream import SnapshotGrid as RGrid
from repro.launch.mesh import make_local_mesh as r_make_local_mesh
from repro_torch import obs
from repro_torch.core import compile as qc
from repro_torch.core import halo, parallel
from repro_torch.core.frontend import TStream
from repro_torch.core.parallel import (check_single_hop_halo,
                                       partition_run, shard_map_run,
                                       slice_grid)
from repro_torch.core.plan import plan_query
from repro_torch.core.stream import SnapshotGrid
from repro_torch.launch.mesh import AxisComm, make_local_mesh


@pytest.fixture(scope="module")
def mesh1():
    return make_local_mesh(n_data=1, device="cpu")


def _grid(vals, valid, t0=0, prec=1):
    return SnapshotGrid(value=torch.from_numpy(np.array(vals)),
                        valid=torch.from_numpy(np.array(valid)), t0=t0,
                        prec=prec)


def _rgrid(vals, valid, t0=0, prec=1):
    return RGrid(value=jnp.asarray(vals), valid=jnp.asarray(valid), t0=t0,
                 prec=prec)


def _int_data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 100, n).astype(np.float32),
            rng.random(n) > 0.2)


def _same(ref, got, ctx=""):
    m1, m2 = np.asarray(ref.valid), np.asarray(got.valid)
    assert np.array_equal(m1, m2), (ctx, m1.sum(), m2.sum())
    assert np.array_equal(np.asarray(ref.value)[m1],
                          np.asarray(got.value)[m1]), ctx


# ---------------------------------------------------------------------------
# schedule math
# ---------------------------------------------------------------------------

def test_hop_count_threshold():
    """halo == core is single-hop; halo == core + 1 is the first config
    that needs the chain."""
    assert halo.hop_count(0, 64) == 0
    assert halo.hop_count(64, 64) == 1
    assert halo.hop_count(65, 64) == 2
    assert halo.hop_count(128, 64) == 2
    assert halo.hop_count(129, 64) == 3
    assert halo.hop_count(500, 128) == 4
    with pytest.raises(ValueError):
        halo.hop_count(1, 0)


def test_schedule_hop_contributions():
    s = halo.schedule(500, 0, 128)
    assert s.left_hops == (128, 128, 128, 116)
    assert s.right_hops == ()
    assert s.left_halo == 500 and s.right_halo == 0
    assert s.max_hops == 4
    assert halo.schedule(256, 0, 128).left_hops == (128, 128)
    two = halo.schedule(10, 130, 64)
    assert two.left_hops == (10,)
    assert two.right_hops == (64, 64, 2)
    assert halo.schedule(500, 0, 128) is s


def test_input_spec_carries_schedule():
    q = TStream.source("in", prec=1).window(100).sum()
    qp = plan_query(q.node, out_len=32)
    sched = qp.input_specs["in"].halo_schedule()
    assert sched.core == 32
    assert sum(sched.left_hops) == qp.input_specs["in"].left_halo
    assert len(sched.left_hops) == 4


def test_check_single_hop_halo_reports_instead_of_raising():
    q = TStream.source("in", prec=1).window(100).sum()
    for out_len, hops in ((100, 1), (99, 2), (50, 2), (33, 4), (32, 4)):
        exe = qc.compile_query(q.node, out_len=out_len)
        rep = check_single_hop_halo(exe.input_specs, exe.out_prec, n=8)
        assert rep["in"].left_hops == hops, out_len
        assert rep["in"].min_single_hop_out_len == 100
    exe = qc.compile_query(q.node, out_len=100)
    assert check_single_hop_halo(
        exe.input_specs, exe.out_prec, n=8)["in"].max_hops == 1


_GRID = [(h, c, n) for h in (0, 1, 63, 64, 65, 100, 500)
         for c in (1, 32, 64, 128) for n in (1, 2, 3, 8)]


@pytest.mark.parametrize("halo_t,core,n", _GRID)
def test_planning_arithmetic_equals_reference(halo_t, core, n):
    """``hop_count``, ``schedule`` (both sides) and ``exchange_cost`` equal
    the reference's at every point of the grid."""
    assert halo.hop_count(halo_t, core) == rhalo.hop_count(halo_t, core)
    for left, right in ((halo_t, 0), (0, halo_t), (halo_t, core + 1)):
        s, rs = halo.schedule(left, right, core), rhalo.schedule(
            left, right, core)
        assert (s.left_hops, s.right_hops, s.core) == (
            rs.left_hops, rs.right_hops, rs.core)
        assert halo.exchange_cost(s, n) == rhalo.exchange_cost(rs, n)


@pytest.mark.parametrize("kind", ["window", "shift", "join"])
@pytest.mark.parametrize("out_len", [8, 33, 100])
def test_check_single_hop_halo_equals_reference(kind, out_len):
    def q(T):
        s = T.source("in", prec=1)
        if kind == "window":
            return s.window(100).sum()
        if kind == "shift":
            return s.shift(-70)
        return s.window(40).mean().join(s.shift(-9), lambda a, b: a - b)

    exe = qc.compile_query(q(TStream).node, out_len=out_len)
    rexe = rqc.compile_query(q(RTStream).node, out_len=out_len,
                             pallas=False)
    for n in (1, 2, 8):
        got = check_single_hop_halo(exe.input_specs, exe.out_prec, n)
        want = r_check(rexe.input_specs, rexe.out_prec, n)
        assert {k: (v.left_hops, v.right_hops, v.min_single_hop_out_len)
                for k, v in got.items()} == {
            k: (v.left_hops, v.right_hops, v.min_single_hop_out_len)
            for k, v in want.items()}, (kind, out_len, n)


# ---------------------------------------------------------------------------
# the exchange: the halo comes over the hops, from nothing else
# ---------------------------------------------------------------------------

class _ChainComm(AxisComm):
    """Rank ``rank`` of ``n``: each hop is answered by the neighbour chain
    from the *clean* global grid — hop ``k`` of the left chain delivers
    rank ``rank - k``'s core slab (its last ticks when trimmed), of the
    right chain rank ``rank + k``'s (its first ticks), φ past the ends —
    and checks that what the rank sends has the length the schedule
    says."""

    def __init__(self, rank, n, value, valid, core, sched):
        super().__init__(None, rank, n, torch.device("cpu"))
        self.global_ = (value, valid)
        self.core, self.sched = core, sched
        self.sent = {True: 0, False: 0}

    def hop(self, tensors, left):
        k = self.sent[left] = self.sent[left] + 1
        hops = self.sched.left_hops if left else self.sched.right_hops
        take = tensors[-1].shape[-1]
        assert take == (hops[k - 1] if k == len(hops) else self.core)
        src = self.rank - k if left else self.rank + k
        out = []
        for g in self.global_:
            if 0 <= src < self.n:
                slab = g[..., src * self.core:(src + 1) * self.core]
                out.append(slab[..., -take:] if left else slab[..., :take])
            else:
                out.append(torch.zeros(g.shape[:-1] + (take,),
                                       dtype=g.dtype))
        return out


@pytest.mark.parametrize("q,N,rank", [
    ("lb100", 512, 5), ("lb100", 512, 1), ("lb100", 320, 7),
    ("lb500", 1024, 6), ("la150", 512, 2), ("la150", 512, 3),
    ("both", 256, 4)])
def test_exchange_halo_arrives_only_through_the_hops(q, N, rank):
    n = 8
    s = TStream.source("in", prec=1)
    rs = RTStream.source("in", prec=1)

    def build(src):
        if q.startswith("lb"):
            return src.window(int(q[2:])).sum()
        if q.startswith("la"):
            return src.shift(-int(q[2:]))
        return src.window(70).sum().join(src.shift(-40), lambda a, b: a + b)

    vals, valid = _int_data(N, seed=N + rank)
    exe = qc.compile_query(build(s).node, out_len=N // n)
    spec = exe.input_specs["in"]
    core = spec.core
    clean = _grid(vals, valid)
    # this rank's copy of the global grid: garbage outside its own core
    pv, pm = vals.copy(), valid.copy()
    outside = np.ones(N, bool)
    outside[rank * core:(rank + 1) * core] = False
    pv[outside] = 1e6
    pm[outside] = ~pm[outside]
    poisoned = {"in": _grid(pv, pm)}
    comm = _ChainComm(rank, n, clean.value, clean.valid, core,
                      spec.halo_schedule())
    placed, t0 = parallel.place_core_inputs(exe.input_specs, poisoned, comm)
    full = {"in": halo.exchange(spec.halo_schedule(), *placed[0], comm)}
    assert comm.sent[True] == min(len(spec.halo_schedule().left_hops), n - 1)
    ov, om = exe.fn(full)
    got = SnapshotGrid(value=ov, valid=om, t0=t0, prec=1)

    rexe = rqc.compile_query(build(rs).node, out_len=N // n, pallas=False)
    ref = r_partition_run(rexe, {"in": _rgrid(vals, valid)}, 0, n)
    S = N // n
    part = RGrid(value=ref.value[rank * S:(rank + 1) * S],
                 valid=ref.valid[rank * S:(rank + 1) * S], t0=0, prec=1)
    _same(part, got, (q, N, rank))
    # the poison matters: read from the rank's own copy, the halo differs
    bad = partition_run(exe, poisoned, 0, n)
    bv, bm = bad.value[rank * S:(rank + 1) * S], bad.valid[rank * S:
                                                           (rank + 1) * S]
    assert not (torch.equal(bm, got.valid)
                and torch.equal(bv[bm], got.value[got.valid]))


def test_record_exchange_counts_equal_reference():
    """The ``halo.*`` counters of one run over 8 shards (static planning
    arithmetic, nothing on the device) equal the reference's."""
    s, rs = TStream.source("in", prec=1), RTStream.source("in", prec=1)
    exe = qc.compile_query(s.window(500).sum().node, out_len=128)
    rexe = rqc.compile_query(rs.window(500).sum().node, out_len=128,
                             pallas=False)
    vals, valid = _int_data(1024)
    comm = AxisComm(None, 0, 8, torch.device("cpu"))
    placed, _ = parallel.place_core_inputs(exe.input_specs,
                                           {"in": _grid(vals, valid)}, comm)

    class _Mesh8:
        shape = {"data": 8}

    rplaced = [(jnp.asarray(vals[:128]), jnp.asarray(valid[:128]))]
    names = ("halo.runs", "halo.hops", "halo.exchange_ticks",
             "halo.exchange_bytes")
    before = obs.default().snapshot()
    parallel.record_exchange(exe.input_specs, placed, comm)
    after = obs.default().snapshot()
    rbefore = robs.default().snapshot()
    r_record_exchange(rexe.input_specs, rplaced, _Mesh8, "data")
    rafter = robs.default().snapshot()
    got = {k: obs.counter_delta(before, after, k) for k in names}
    want = {k: robs.counter_delta(rbefore, rafter, k) for k in names}
    assert got == want and got["halo.hops"] == 4, (got, want)


# ---------------------------------------------------------------------------
# shard_map_run on the 1-rank mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [False, True])
def test_shard_map_run_nonzero_origin_matches_partition_run(mesh1, sparse):
    """The sharded output grid starts where the inputs' core region
    starts; it equals ``partition_run`` and the reference's
    ``shard_map_run`` on its 1-device mesh."""
    N, T0 = 64, 960
    vals, valid = _int_data(N, seed=3)
    vals[20:40] = vals[20]
    g = {"in": _grid(vals, valid, t0=T0)}
    q = TStream.source("in", prec=1).window(8).sum()
    exe = qc.compile_query(q.node, out_len=N, sparse=sparse)
    ref = partition_run(exe, g, T0, 1)
    out = shard_map_run(exe, g, mesh1)
    assert out.t0 == T0 and ref.t0 == T0
    _same(ref, out)
    rq = RTStream.source("in", prec=1).window(8).sum()
    rexe = rqc.compile_query(rq.node, out_len=N, pallas=False, sparse=sparse)
    rout = r_shard_map_run(rexe, {"in": _rgrid(vals, valid, t0=T0)},
                           r_make_local_mesh(n_data=1))
    _same(rout, out, "reference")


def test_shard_map_run_core_length_is_real_exception(mesh1):
    vals, valid = _int_data(48, seed=4)
    q = TStream.source("in", prec=1).window(8).sum()
    exe = qc.compile_query(q.node, out_len=64)
    with pytest.raises(ValueError, match="core length"):
        shard_map_run(exe, {"in": _grid(vals, valid)}, mesh1)


def test_shard_map_run_rejects_disagreeing_origins(mesh1):
    N = 32
    a = TStream.source("a", prec=1)
    b = TStream.source("b", prec=1)
    q = a.window(4).sum().join(b.window(4).sum(), lambda x, y: x + y)
    exe = qc.compile_query(q.node, out_len=N)
    va, ma = _int_data(N, seed=5)
    vb, mb = _int_data(N, seed=6)
    with pytest.raises(ValueError, match="core-region origin"):
        shard_map_run(exe, {"a": _grid(va, ma, t0=0),
                            "b": _grid(vb, mb, t0=32)}, mesh1)


def test_grid_window_misalignment_raises():
    N = 32
    vals, valid = _int_data(N, seed=7)
    g = {"in": _grid(vals, valid, prec=2)}
    q = TStream.source("in", prec=2).window(8).sum()
    exe = qc.compile_query(q.node, out_len=8)
    partition_run(exe, g, 0, 1)  # aligned: fine
    with pytest.raises(ValueError, match="misaligned"):
        partition_run(exe, g, 1, 1)


def test_slice_grid_misalignment_is_real_exception():
    vals, valid = _int_data(16, seed=8)
    g = _grid(vals, valid, prec=2)
    with pytest.raises(ValueError, match="misaligned"):
        slice_grid(g, 1, 9)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_keeps_the_reference_shapes(multi_pod,
                                                         monkeypatch):
    """The production mesh asks for the reference's shape and axis names
    (the mesh itself needs 256 or 512 ranks, so both builders are
    replaced by recorders), on the card."""
    from repro.launch import mesh as rmesh
    from repro_torch.launch import mesh as lm
    asked = {}
    monkeypatch.setattr(rmesh.jax, "make_mesh", lambda shape, axes: asked
                        .setdefault("ref", (tuple(shape), tuple(axes))))
    monkeypatch.setattr(lm, "init_device_mesh", lambda dev, shape, *,
                        mesh_dim_names: asked.setdefault(
                            "port", (dev, tuple(shape),
                                     tuple(mesh_dim_names))))
    rmesh.make_production_mesh(multi_pod=multi_pod)
    lm.make_production_mesh(multi_pod=multi_pod)
    assert asked["port"] == ("cuda",) + asked["ref"]


_RESTART = textwrap.dedent("""
    import gc
    import sys
    sys.path.insert(0, {src!r})
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import axis_comm, make_local_mesh
    torch.set_num_threads(1)
    first = make_local_mesh(device="cpu")
    assert make_local_mesh(device="cpu") is first
    first = id(first)
    dist.destroy_process_group()
    gc.collect()
    again = make_local_mesh(device="cpu")
    comm = axis_comm(again)
    assert id(again) != first
    got = comm.all_gather(torch.arange(3.0))
    assert torch.equal(got, torch.arange(3.0)), got
    print("ok")
""")


def test_make_local_mesh_after_the_default_group_restarts():
    """A default group destroyed and started again gets a mesh of its own
    (the old one's groups are gone), which gathers.  In a subprocess: the
    default group of this process is shared with other tests."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    out = subprocess.run([sys.executable, "-c", _RESTART.format(src=src)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
