"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

One module fixture runs one subprocess with a ``fake`` process group of 8
ranks as a (2 data × 4 model) mesh (a fake group and a real one cannot
share a process) and traces qwen3-1.7b's SMOKE configuration at a train,
a prefill and a decode shape (``trace_cell``).  Each cell must come back
``ok`` with the roofline's fields, its collectives recorded, and its
argument bytes equal to a hand sum of rank 0's shards (each dimension
split as ``torch.chunk`` splits it over the axes its spec names).  The
same subprocess then traces one train step on a (1, 1) mesh over one of
its ranks, whose FLOPs must equal PyTorch's ``FlopCounterMode`` over one
real eager step of the same configuration and batch.

A full-size cell made to fail (qwen3-1.7b with 3 kv heads, which divide
none of its 16 query heads) comes back from the command line as data,
``ok: false`` with its error, and exit code 1; so does a cell past
``--timeout`` under ``--all``, which traces only the cells its
``--arch``/``--shape`` name.  With no card visible and no ``--device
cpu``, the command line raises before tracing anything.  ``all_cells()`` equals
the reference's (computed in a subprocess: importing the reference's
dry-run sets XLA's device count for the whole process).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300

CELLS = r'''
import dataclasses, json, warnings
warnings.simplefilter("ignore")
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils.flop_counter import FlopCounterMode
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun, sharding as SH
from repro_torch.models import build_model
from repro_torch.train import init_opt_state, make_train_step

mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
sizes = {"data": 2, "model": 4}
cfg = get_config("qwen3-1.7b", smoke=True)
shapes = {"train": dataclasses.replace(SHAPES["train_4k"], global_batch=8,
                                       seq_len=32),
          "prefill": dataclasses.replace(SHAPES["prefill_32k"],
                                         global_batch=4, seq_len=32),
          "decode": dataclasses.replace(SHAPES["decode_32k"],
                                        global_batch=4, seq_len=64)}


def local_bytes(shape, dtype, spec):
    n = 1
    for d, size in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = (e,) if isinstance(e, str) else tuple(e or ())
        for a in axes:
            size = -(-size // sizes[a])      # rank 0's torch.chunk
        n *= size
    return n * torch.empty((), dtype=dtype).element_size()


model = build_model(cfg, device="meta")
params = dict(model.init().named_parameters())
psh = SH.param_shardings(model.param_axes(), cfg, sizes)
p_bytes = sum(local_bytes(p.shape, p.dtype, psh[n].spec)
              for n, p in params.items())
m_bytes = sum(local_bytes(p.shape, torch.float32, psh[n].spec)
              for n, p in params.items())
out = {}
for kind, shape in shapes.items():
    rec = dryrun.trace_cell(cfg, shape, mesh, "cpu",
                            4 if kind == "train" else 1)
    specs = model.input_specs(shape)
    want = p_bytes
    if kind == "train":
        want += 2 * m_bytes + 4
    for k, v in specs.items():
        if k == "caches":
            csh = SH.cache_shardings(model.cache_axes(shape.seq_len), v,
                                     cfg, sizes)
            for st, sh in zip(v, csh):
                leaves = ([(st.k, sh.k), (st.v, sh.v), (st.pos, sh.pos)]
                          if hasattr(st, "k") else
                          [(st[x], sh[x]) for x in st])
                want += sum(local_bytes(t.shape, t.dtype, s.spec)
                            for t, s in leaves)
        else:
            want += local_bytes(v.shape, v.dtype,
                                SH.batch_sharding_for(sizes, v).spec
                                if v.dim() else ())
    if kind == "prefill":
        # the prefill's caches, preallocated at (B, S) and filled in place
        caches = model.init_cache(shape.global_batch, shape.seq_len)
        csh = SH.cache_shardings(model.cache_axes(shape.seq_len), caches,
                                 cfg, sizes)
        for st, sh in zip(caches, csh):
            for t, s in ((st.k, sh.k), (st.v, sh.v), (st.pos, sh.pos)):
                want += local_bytes(t.shape, t.dtype, s.spec)
    out[kind] = {"rec": rec, "hand_bytes": want}

# a (1, 1) mesh over rank 0: the traced FLOPs against a real eager step
one = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
shape = shapes["train"]
rec = dryrun.trace_cell(cfg, shape, one, "cpu", 1)
real = build_model(cfg, device="cpu")
p = real.init(torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
batch = {k: torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                          generator=g, dtype=torch.int32)
         for k in ("tokens", "labels")}
with FlopCounterMode(display=False) as fc:
    make_train_step(real).eager(p, init_opt_state(p), batch)
out["local"] = {"rec": rec, "flops": fc.get_total_flops()}
print("CELLS" + json.dumps(out))
'''


def _env():
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
           if k in os.environ}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS", "cpu")
    return env


def _run(args, ok=True, env=None):
    p = subprocess.run([sys.executable, *args], cwd=ROOT,
                       env={**_env(), **(env or {})},
                       capture_output=True, text=True, timeout=TIMEOUT)
    if ok:
        assert p.returncode == 0, f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}"
    return p


@pytest.fixture(scope="module")
def cells():
    out = _run(["-c", textwrap.dedent(CELLS)]).stdout
    line = next(ln for ln in out.splitlines() if ln.startswith("CELLS"))
    return json.loads(line[len("CELLS"):])


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cells_trace_on_a_2x4_mesh(cells, kind):
    rec = cells[kind]["rec"]
    assert rec["ok"] and rec["devices"] == 8
    assert rec["n_micro"] == (4 if kind == "train" else 1)
    assert rec["memory"]["argument_size_in_bytes"] == cells[kind][
        "hand_bytes"]
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["per_device_bytes"] == sum(rec["memory"].values())
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["coll"] and all(
        c["group"] in (2, 4, 8) and c["bytes"] > 0 and c["count"] >= 1
        for c in rec["coll"])
    roof = rec["roofline"]
    assert {"flops", "hbm_bytes", "coll_bytes", "coll_breakdown",
            "compute_s", "memory_s", "collective_s", "dominant",
            "model_flops", "useful_ratio",
            "roofline_fraction"} <= roof.keys()
    assert roof["coll_bytes"] > 0 and roof["dominant"] in (
        "compute", "memory", "collective")
    assert roof["flops"] == rec["cost"]["flops"]


def test_train_cell_moves_gradients_across_the_mesh(cells):
    """A sharded train step reduces gradients (all-reduce or
    reduce-scatter) and gathers FSDP-sharded weights (all-gather)."""
    kinds = {c["kind"] for c in cells["train"]["rec"]["coll"]}
    assert "all-gather" in kinds
    assert kinds & {"all-reduce", "reduce-scatter"}


def test_local_mesh_flops_equal_a_real_eager_step(cells):
    """On a (1, 1) mesh the traced program is the whole step: its FLOPs
    equal ``FlopCounterMode``'s over one real eager step, and nothing
    crosses the wire."""
    rec = cells["local"]["rec"]
    assert rec["ok"] and rec["devices"] == 1
    assert rec["cost"]["flops"] == cells["local"]["flops"] > 0
    assert rec["roofline"]["coll_bytes"] == 0


def test_a_failing_cell_is_data(tmp_path):
    out = tmp_path / "cell.json"
    p = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen3-1.7b",
              "--shape", "train_4k", "--mesh", "single", "--set",
              "n_kv_heads=3", "--json", str(out), "--device", "cpu"],
             ok=False)
    assert p.returncode == 1, p.stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["ok"] is False and res["arch"] == "qwen3-1.7b"
    assert res["device_type"] == "cpu"
    assert res["error"].startswith("RuntimeError")
    assert res["error"].split(":")[-1].strip() in res["trace"]
    assert '"ok": false' in p.stdout


@pytest.mark.parametrize("mesh", ["single", "local"])
def test_no_card_and_no_device_flag_traces_nothing(tmp_path, mesh):
    """Without a card (none visible) the dry-run traces only when
    ``--device cpu`` asks for the CPU: it raises before any cell, and
    records none."""
    out = tmp_path / "cell.json"
    p = _run(["-m", "repro_torch.launch.dryrun", "--arch", "qwen3-1.7b",
              "--shape", "train_4k", "--mesh", mesh, "--json", str(out)],
             ok=False, env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and "device='cpu'" in p.stderr
    assert not out.exists()


def test_all_runs_the_cells_asked_for(tmp_path):
    """``--all --arch A --shape S`` traces only that cell, in its own
    process; a second run skips it as cached."""
    args = ["-m", "repro_torch.launch.dryrun", "--all", "--arch",
            "qwen3-1.7b", "--shape", "decode_32k", "--out-dir",
            str(tmp_path), "--device", "cpu", "--jobs", "2"]
    p = _run(args)
    assert "OK   qwen3-1.7b" in p.stdout
    assert [f.name for f in tmp_path.iterdir()] == [
        "qwen3-1.7b_decode_32k_single.json"]
    rec = json.loads((tmp_path / "qwen3-1.7b_decode_32k_single.json")
                     .read_text())
    assert rec["ok"] and rec["devices"] == 256 and rec["device_type"] == "cpu"
    assert "SKIP (cached) qwen3-1.7b decode_32k single" in _run(args).stdout


def test_a_cell_past_its_timeout_is_data(tmp_path):
    p = _run(["-m", "repro_torch.launch.dryrun", "--all", "--arch",
              "qwen3-1.7b", "--shape", "train_4k", "--out-dir",
              str(tmp_path), "--device", "cpu", "--timeout", "1"], ok=False)
    assert p.returncode == 1 and "FAIL qwen3-1.7b" in p.stdout
    rec = json.loads((tmp_path / "qwen3-1.7b_train_4k_single.json")
                     .read_text())
    assert rec == {"arch": "qwen3-1.7b", "shape": "train_4k",
                   "mesh": "single", "device_type": "cpu", "ok": False,
                   "error": "trace timeout"}


def test_all_cells_equal_the_reference():
    from repro_torch.launch.dryrun import all_cells
    ref = _run(["-c", "import json; from repro.launch.dryrun import "
                "all_cells; print(json.dumps(all_cells()))"]).stdout
    assert [list(c) for c in all_cells()] == json.loads(
        ref.strip().splitlines()[-1])
