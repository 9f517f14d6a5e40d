"""The port's multi-device paths on 8 ranks against the reference's on 8
devices, mirroring the six TiLT cases of ``tests/test_parallel_multidev.py``:
the halo exchange, multi-hop left and right chains at non-zero origins,
sparse ``shard_map_run``, ``shard_union_run`` over deep windows, the runner
at ``placement=mesh`` (single-keyed and keyed, dense and sparse, and
``KeyedEngine(mesh=)``), and the sparse keyed union session on a mesh.

One module fixture computes everything once: the reference's outputs in
one JAX subprocess with 8 forced host devices, the port's in one launch of
8 plain ``python`` processes, one per rank, joined in a gloo process group
over a ``file://`` store under the test's temporary directory (no TCP
port, so parallel test workers cannot collide).  Each rank runs with one
thread, ``init_process_group`` has a 60 s timeout and every subprocess
its own, so a rank that dies fails the fixture instead of hanging it.
Both launches run at once, and every rank saves what it got: every output
comes back whole on every rank, and each rank's is held against the
reference.

Data is integer-valued where the reference's test holds bit identity, and
those comparisons are exact; the float halo case uses the reference
test's own ``rtol=atol=1e-5``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 8
TIMEOUT = 240

# data and queries, the same text in both subprocesses (``TS`` is the
# package's TStream)
COMMON = r'''
import numpy as np

N_RANKS = 8
MULTIHOP = [("lb", 100, 512, 0), ("lb", 100, 320, 0), ("lb", 500, 1024, 0),
            ("lb", 500, 1024, 4096), ("la", 150, 512, 0),
            ("la", 70, 256, 128)]


def pw(shape, rate, seed):
    rng = np.random.default_rng(seed)
    ch = rng.random(shape) < rate
    ch[..., 0] = True
    raw = np.floor(rng.random(shape) * 100).astype(np.float32)
    idx = np.maximum.accumulate(np.where(ch, np.arange(shape[-1]), -1),
                                axis=-1)
    vals = (np.take_along_axis(raw, idx, axis=-1) if len(shape) > 1
            else raw[idx])
    return vals, np.ones(shape, bool)


def trend(s):
    return (s.window(16).mean()
            .join(s.window(32).mean(), lambda a, b: a - b)
            .where(lambda d: d > 0))


def bands(s):
    return s.window(24).max().join(s, lambda h, x: h - x)


def halo_case(TS):
    """The reference test's float query, gated (``d > 0``) and not: the
    gate flips where the two packages' float association differs by an ulp
    around 0, so only the ungated difference is held across packages."""
    rng = np.random.default_rng(0)
    vals = rng.normal(size=1024).astype(np.float32)
    valid = rng.random(1024) > 0.2
    s = TS.source("in", prec=1)
    d = s.window(20).mean().join(s.window(50).mean(), lambda a, b: a - b)
    return d.where(lambda x: x > 0), d, vals, valid


def multihop_case(TS, kind, W, N):
    rng = np.random.default_rng(W + N)
    vals = rng.integers(0, 100, N).astype(np.float32)
    valid = rng.random(N) > 0.2
    s = TS.source("in", prec=1)
    return (s.window(W).sum() if kind == "lb" else s.shift(-W)), vals, valid


def sparse_case(TS):
    vals = np.full(512, 11.0, np.float32)
    vals[140:] = 4.0
    vals[300:] = 27.0
    valid = np.ones(512, bool)
    valid[200:230] = False
    return TS.source("in", prec=1).window(100).sum(), vals, valid


def union_case(TS):
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 50, 512).astype(np.float32)
    valid = rng.random(512) > 0.2
    s = TS.source("in", prec=1)
    return ({"shallow": s.window(16).mean(), "deep": s.window(200).sum()},
            vals, valid)


def keyed_case():
    K, T = 32, 256
    kv, km = pw((K, T), 0.0, seed=2)
    av, am = pw((4, T), 0.2, seed=3)
    kv[::8], km[::8] = av, am
    return kv, km


def session_case():
    K, T = 16, 256
    rng = np.random.default_rng(7)
    ch = rng.random((K, T)) < 0.03
    ch[:, 0] = True
    raw = np.floor(rng.random((K, T)) * 100).astype(np.float32)
    idx = np.maximum.accumulate(np.where(ch, np.arange(T), -1), axis=-1)
    return np.take_along_axis(raw, idx, axis=-1), np.ones((K, T), bool)
'''

REF = r'''
import os, sys, warnings
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
warnings.simplefilter("ignore", DeprecationWarning)
import jax, jax.numpy as jnp
from repro.core import compile as qc
from repro.core.frontend import TStream as TS
from repro.core.parallel import (check_single_hop_halo, partition_run,
                                 shard_map_run)
from repro.core.sparse import segment_mask
from repro.core.stream import SnapshotGrid
from repro.engine import (ExecPolicy, KeyedEngine, Runner, keyed_grid,
                          mesh_placement)
from repro.launch.mesh import make_local_mesh
from repro.multiquery import MultiQuerySession, shard_union_run

assert len(jax.devices()) == N_RANKS
mesh = make_local_mesh(n_data=N_RANKS)
# the chunked paths on a 1-D mesh, as the reference's own test places them
run_mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
res = {}


def put(name, g):
    res[name + "/v"] = np.asarray(g.value)
    res[name + "/m"] = np.asarray(g.valid)


def G(v, m, t0=0):
    return SnapshotGrid(value=jnp.asarray(v), valid=jnp.asarray(m), t0=t0,
                        prec=1)


def record_caps(tag, exe, runner):
    # every branch of the per-shard ladder is staged (lax.switch)
    res[tag] = np.array(sorted(k[-1] for k in exe._runner_step_cache
                               if isinstance(k, tuple)
                               and k[0] == "compute"))


def compile_(q, out_len, sparse=False):
    return qc.compile_query(q.node, out_len=out_len, pallas=False,
                            sparse=sparse)
'''

PORT = r'''
import datetime, os, sys, warnings
warnings.simplefilter("ignore", DeprecationWarning)
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.core import compile as qc
from repro_torch.core.frontend import TStream as TS
from repro_torch.core.parallel import (check_single_hop_halo,
                                       partition_run, shard_map_run)
from repro_torch.core.sparse import segment_mask
from repro_torch.core.stream import SnapshotGrid
from repro_torch.engine import (ExecPolicy, KeyedEngine, Runner,
                                mesh_placement)
from repro_torch.engine import keyed_grid as _keyed_grid
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.multiquery import MultiQuerySession, shard_union_run

mesh = run_mesh = make_local_mesh(n_data=N_RANKS, device="cpu")
res = {}


def put(name, g):
    res[name + "/v"] = g.value.numpy()
    res[name + "/m"] = g.valid.numpy()


def G(v, m, t0=0):
    return SnapshotGrid(value=torch.from_numpy(v), valid=torch.from_numpy(m),
                        t0=t0, prec=1)


def keyed_grid(v, m):
    return _keyed_grid(v, m, device="cpu")


# the capacities of the compacted bodies each runner ran, by runner
ran = {}
build_body = Runner._sparse_body


def spied_body(self, cap, dev):
    body = build_body(self, cap, dev)

    def run(work):
        ran.setdefault(id(self), []).append(cap)
        return body(work)
    return run


Runner._sparse_body = spied_body


def record_caps(tag, exe, runner):
    # the per-shard ladder, the buckets of the bodies this rank's chunks
    # ran, and those the bucket metric counted
    res[tag] = np.array(runner.capacity_ladder())
    res[tag + "_used"] = np.array(sorted(set(ran.pop(id(runner)))))
    picks = runner.metrics.snapshot()["vectors"]["runner.bucket_picks"]
    res[tag + "_picked"] = np.array(sorted(
        int(c) for c, n in zip(picks["labels"], picks["values"]) if n))


def compile_(q, out_len, sparse=False):
    return qc.compile_query(q.node, out_len=out_len, sparse=sparse)
'''

# the cases, the same text in both subprocesses after their preamble
CASES = r'''
# 1. the halo exchange (float data): the gated query against the same
# package's host loop at the same partitioning, the difference against
# the other package
gated, diff, v, m = halo_case(TS)
exe = compile_(gated, 1024 // N_RANKS)
put("halo_same/shard", shard_map_run(exe, {"in": G(v, m)}, mesh,
                                     axis="data"))
put("halo_same/loop", partition_run(exe, {"in": G(v, m)}, 0, N_RANKS))
put("halo/diff", shard_map_run(compile_(diff, 1024 // N_RANKS),
                               {"in": G(v, m)}, mesh, axis="data"))

# 2. multi-hop left and right chains, non-zero origins, dense and sparse
for kind, W, N, t0 in MULTIHOP:
    q, v, m = multihop_case(TS, kind, W, N)
    for sparse in (False, True):
        exe = compile_(q, N // N_RANKS, sparse)
        rep = check_single_hop_halo(exe.input_specs, exe.out_prec, N_RANKS)
        tag = f"mh/{kind}{W}_{N}_{t0}_{int(sparse)}"
        res[tag + "/hops"] = np.array([rep["in"].left_hops,
                                       rep["in"].right_hops])
        put(tag, shard_map_run(exe, {"in": G(v, m, t0)}, mesh, axis="data"))

# 3. sparse shard_map_run: a change whose lookback crosses shards
q, v, m = sparse_case(TS)
exe = compile_(q, 512 // N_RANKS, True)
g = {"in": G(v, m)}
res["sparse/mask"] = np.asarray(segment_mask(exe, g, 0, N_RANKS))
put("sparse", shard_map_run(exe, g, mesh, axis="data"))

# 4. shard_union_run over a 4-hop merged halo
qs, v, m = union_case(TS)
outs = shard_union_run(qs, 512 // N_RANKS, {"in": G(v, m)}, mesh,
                       axis="data")
for name in qs:
    put(f"union/{name}", outs[name])

# 5. the runner at placement=mesh: segments shard (single), keys shard
v, m = pw((512,), 0.02, seed=1)
g = {"in": G(v, m)}
for body in ("dense", "sparse"):
    exe = compile_(trend(TS.source("in", prec=1)), 32, body == "sparse")
    r = Runner(exe, ExecPolicy(body=body, placement=mesh_placement(run_mesh)),
               segs_per_chunk=8)
    put(f"runner/single_{body}", r.run(g, 512 // 256))
    if body == "sparse":
        record_caps("caps/single", exe, r)
kv, km = keyed_case()
gk = {"in": keyed_grid(kv, km)}
for body in ("dense", "sparse"):
    exe = compile_(trend(TS.source("in", keyed=True)), 256 // 4,
                   body == "sparse")
    r = Runner(exe, ExecPolicy(body=body, keys="vmapped",
                               placement=mesh_placement(run_mesh)),
               n_keys=32)
    put(f"runner/keyed_{body}", r.run(gk, 4))
    if body == "sparse":
        record_caps("caps/keyed", exe, r)
        put("runner/keyed_engine",
            KeyedEngine(exe, n_keys=32, mesh=run_mesh, sparse=True
                        ).run(gk, 4))

# 6. the sparse keyed union session on the mesh
v, m = session_case()
sess = (MultiQuerySession(64, n_keys=16, mesh=run_mesh, pallas=False,
                          sparse=True)
        if "jax" in sys.modules else
        MultiQuerySession(64, n_keys=16, mesh=run_mesh, sparse=True))
s = TS.source("in", prec=1, keyed=True)
for name, q in (("trend", trend(s)), ("bands", bands(s))):
    sess.attach(name, q)
outs = sess.run({"in": keyed_grid(v, m)}, 256 // 64)
for name in ("trend", "bands"):
    put(f"session/{name}", outs[name])
'''


# the port alone: the shard_map_run cases above again with jit=False
# (eager steps, the sparse flag read on the host), beside the staged ones
# (one Staged/StagedSwitch per step, its body picked from a device flag),
# and which kind of step each staged case cached
PORT_EAGER = r'''
def eager_(q, out_len, sparse=False):
    return qc.compile_query(q.node, out_len=out_len, sparse=sparse,
                            jit=False)


for kind, W, N, t0 in MULTIHOP:
    q, v, m = multihop_case(TS, kind, W, N)
    for sparse in (False, True):
        tag = f"mh/{kind}{W}_{N}_{t0}_{int(sparse)}"
        put("eager/" + tag, shard_map_run(eager_(q, N // N_RANKS, sparse),
                                          {"in": G(v, m, t0)}, mesh,
                                          axis="data"))
q, v, m = sparse_case(TS)
put("eager/sparse", shard_map_run(eager_(q, 512 // N_RANKS, True),
                                  {"in": G(v, m)}, mesh, axis="data"))
kinds = []
for sparse in (False, True):
    exe = compile_(q, 512 // N_RANKS, sparse)
    for _ in range(3):
        shard_map_run(exe, {"in": G(v, m)}, mesh, axis="data")
    (step,) = exe._shard_step_cache.values()
    kinds.append(f"{type(step).__name__}:{len(step.entries)}")
res["staged/kinds"] = np.array(kinds)
'''


def _env():
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
           if k in os.environ}
    env["PYTHONPATH"] = str(ROOT / "src")
    # without it jax probes for a TPU backend and hangs on isolated hosts
    env["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS", "cpu")
    return env


def _wait(proc, what):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{what} timed out\n{err[-3000:]}")
    assert proc.returncode == 0, f"{what}: {out}\n{err[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' outputs: ``(reference, [rank 0 .. rank 7])``."""
    d = tmp_path_factory.mktemp("multidev")
    ref_code = (textwrap.dedent(COMMON) + textwrap.dedent(REF)
                + textwrap.dedent(CASES)
                + f"\nnp.savez({str(d / 'ref.npz')!r}, **res)\n")
    port_code = (textwrap.dedent(COMMON) + textwrap.dedent(PORT)
                 + textwrap.dedent(CASES) + textwrap.dedent(PORT_EAGER)
                 + "\nnp.savez(os.path.join(out_dir, f'port_{rank}.npz'),"
                   " **res)\ndist.barrier()\nsys.stdout.flush()\n"
                   "os._exit(0)\n")
    (d / "port.py").write_text(port_code)
    procs = [("reference", subprocess.Popen(
        [sys.executable, "-c", ref_code], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))]
    store = d / "store"
    for r in range(N_RANKS):
        procs.append((f"rank {r}", subprocess.Popen(
            [sys.executable, str(d / "port.py"), str(r), str(N_RANKS),
             str(store), str(d)], cwd=ROOT, env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    try:
        for what, p in procs:
            _wait(p, what)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
    ref = dict(np.load(d / "ref.npz"))
    ports = [dict(np.load(d / f"port_{r}.npz")) for r in range(N_RANKS)]
    return ref, ports


def _check(runs, prefix, exact=True):
    ref, ports = runs
    names = sorted(k[:-2] for k in ref if k.startswith(prefix)
                   and k.endswith("/m"))
    assert names, prefix
    for r, port in enumerate(ports):
        for name in names:
            m1, m2 = ref[name + "/m"], port[name + "/m"]
            assert np.array_equal(m1, m2), (name, r, m1.sum(), m2.sum())
            v1, v2 = ref[name + "/v"][m1], port[name + "/v"][m1]
            if exact:
                assert np.array_equal(v1, v2), (name, r)
            else:
                np.testing.assert_allclose(v2, v1, rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name} rank {r}")
    return names


def test_shard_map_halo_exchange_matches_reference(runs):
    """The hop-chain exchange on 8 ranks reproduces the host loop at the
    same partitioning bit for bit (float data, gated), and the reference's
    8-device result within the reference test's tolerance (the ungated
    difference: a gate at 0 flips on an ulp), windows across shards
    included."""
    _, ports = runs
    for port in ports:
        for part in ("m", "v"):
            assert np.array_equal(port["halo_same/shard/" + part],
                                  port["halo_same/loop/" + part])
    _check(runs, "halo/", exact=False)


@pytest.mark.parametrize("sparse", [0, 1])
def test_shard_map_multi_hop_bit_identical(runs, sparse):
    """2-, 3- and 4-hop left chains (one at a non-zero origin) and 3-hop
    right chains (one at a non-zero origin), dense and sparse, bit for bit
    with the reference's, with the same hop counts."""
    ref, ports = runs
    seen = {}
    for kind, W, N, t0 in [("lb", 100, 512, 0), ("lb", 100, 320, 0),
                           ("lb", 500, 1024, 0), ("lb", 500, 1024, 4096),
                           ("la", 150, 512, 0), ("la", 70, 256, 128)]:
        tag = f"mh/{kind}{W}_{N}_{t0}_{sparse}"
        hops = ref[tag + "/hops"]
        for port in ports:
            assert np.array_equal(port[tag + "/hops"], hops), tag
        n = int(hops.max())
        seen[n] = seen.get(n, 0) + 1
        _check(runs, tag)
    assert seen == {2: 1, 3: 3, 4: 2}, seen


def test_sparse_shard_map_run_matches_reference(runs):
    """Per-shard dirty flags (some shards held, some computed) and the
    output, bit for bit with the reference's."""
    ref, ports = runs
    mask = ref["sparse/mask"]
    assert 1 < mask.sum() < N_RANKS, mask
    for port in ports:
        assert np.array_equal(port["sparse/mask"], mask)
    _check(runs, "sparse")


def test_staged_shard_paths_equal_eager(runs):
    """``shard_map_run`` (every multi-hop chain, dense and sparse, and the
    sparse case) staged (the default) equals the same steps run eagerly
    (``jit=False``) bit for bit on every rank, every tick; each staged
    step is one Staged (dense) or StagedSwitch (sparse) holding one
    geometry after repeated calls."""
    _, ports = runs
    for port in ports:
        eager = sorted(k for k in port if k.startswith("eager/"))
        assert len(eager) == 2 * (2 * 6 + 1)
        for k in eager:
            assert np.array_equal(port[k], port[k[len("eager/"):]]), k
        assert list(port["staged/kinds"]) == ["Staged:1", "StagedSwitch:1"]


def test_shard_union_run_deep_windows_match_reference(runs):
    assert _check(runs, "union") == ["union/deep", "union/shallow"]


def test_policy_mesh_runner_matches_reference(runs):
    """``Runner(placement=mesh)`` single-keyed (segments shard) and keyed
    (keys shard), dense and sparse, and ``KeyedEngine(mesh=, sparse=True)``,
    bit for bit with the reference's on 8 devices; the compaction buckets
    stay per-shard sized, as the reference's."""
    ref, ports = runs
    assert len(_check(runs, "runner")) == 5
    for what, top in (("single", 1), ("keyed", 2)):
        ladder = ref[f"caps/{what}"]          # every branch is staged there
        assert ladder[0] <= top, (what, ladder)
        for port in ports:
            used = port[f"caps/{what}_used"]
            assert np.array_equal(port[f"caps/{what}"], ladder), what
            assert set(used) <= set(ladder) and used[0] <= top, (what, used)
            assert np.array_equal(port[f"caps/{what}_picked"], used), what


def test_sparse_union_session_mesh_matches_reference(runs):
    assert _check(runs, "session") == ["session/bands", "session/trend"]


def test_every_rank_gets_the_whole_result(runs):
    """Every rank returns the global grid (every key, every segment), the
    same bits on all 8."""
    _, ports = runs
    for port in ports[1:]:
        assert sorted(port) == sorted(ports[0])
        for k, a in ports[0].items():
            assert np.array_equal(a, port[k]), k
