"""Elementwise regions run as one program (``repro_torch.core.region``),
on the CPU through the program's plain version
(``repro_torch.kernels.ref.region_program_ref``): bit for bit against the
eager evaluation of the same planned query, and the tracer's lowering of
each op, promotion and read.

Every app of ``data.apps.APPS`` runs both ways on float and on
integer-valued inputs; the regions that stay eager are named with their
reason.
"""
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro_torch.core import compile as qc
from repro_torch.core import ir
from repro_torch.core.frontend import TStream
from repro_torch.core.parallel import partition_run
from repro_torch.core.plan import GridPlan, QueryPlan
from repro_torch.data import apps
from repro_torch.engine import ExecPolicy, Runner, keyed_grid
from repro_torch.kernels import ref
from repro_torch.kernels import region_program as rp

# each app's regions by outcome (impute's gap fill is a φ-aware Map;
# resample has no elementwise node)
EXPECTED = {"trend": {"lowered": 1}, "rsi": {"lowered": 4},
            "znorm": {"lowered": 1}, "impute": {"phi_aware": 1},
            "resample": {}, "pantomkins": {"lowered": 2},
            "vibration": {"lowered": 1}, "fraud": {"lowered": 1},
            "ysb": {"lowered": 1}, "qrs": {"lowered": 3}}


def _same(a, b):
    """Equal bits, NaN where NaN."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(
            a.masked_fill(nan, 0).view(torch.int32),
            b.masked_fill(nan, 0).view(torch.int32)))
    return bool(torch.equal(a, b))


def _both(node, out_len):
    """The query compiled, and the same plan evaluated node by node."""
    exe = qc.compile_query(node, out_len)
    return exe, qc.compile_planned(exe.root, exe.plan, lower=False)


@pytest.mark.parametrize("kind", ["float", "integer"])
@pytest.mark.parametrize("name", sorted(apps.APPS))
def test_every_app_runs_its_regions_as_programs_bit_for_bit(name, kind):
    app = apps.make_app(name)
    data = app.make_input(1 << 12, 7)
    if kind == "integer":
        data = {k: {**d, "value": tree_map(lambda a: np.round(a * 4) - 3,
                                           d["value"])}
                for k, d in data.items()}
    exe, eager = _both(app.query.node, (1 << 10) // app.query.prec)
    grids = apps.make_grids(data, device="cpu")
    got = partition_run(exe, grids, 0, 4)
    want = partition_run(eager, grids, 0, 4)
    assert dict(exe.regions.status()) == EXPECTED[name]
    assert _same(got.valid, want.valid)
    assert _same(got.value, want.value)


def _one(fn, *dtypes, n=300, seed=0, where=None):
    """A Map of ``fn`` over sources ``in0 ..`` of ``dtypes`` (keyed, 3
    keys), lowered and eager on one random input; returns the region and
    both results."""
    srcs = [TStream.source(f"in{i}", keyed=True) for i in range(len(dtypes))]
    q = (srcs[0].select(fn) if len(srcs) == 1
         else TStream.zip(srcs, fn))
    if where is not None:
        q = q.where(where)
    exe, eager = _both(q.node, n)
    rng = np.random.default_rng(seed)
    inp = {}
    for i, dt in enumerate(dtypes):
        L = exe.input_specs[f"in{i}"].length
        x = rng.normal(0, 3, (3, L))
        x[rng.random(x.shape) < 0.1] = 0
        inp[f"in{i}"] = (torch.from_numpy(x).to(dt),
                         torch.from_numpy(rng.random((3, L)) > 0.2))
    (region,) = [r for r in exe.regions.by_root.values()]
    return region, exe.trace_fn(inp), eager.trace_fn(inp)


F, I, B = torch.float32, torch.int32, torch.bool
# one case an opcode (and the calls that lower to it), with the dtypes of
# the sources
OPS = {
    "add": (lambda x, y: x + y, F, F), "radd": (lambda x: 1.5 + x, F),
    "sub": (lambda x, y: x - y, F, F), "rsub": (lambda x: 2.5 - x, F),
    "mul": (lambda x, y: x * y, F, F), "div": (lambda x, y: x / y, F, F),
    "divc": (lambda x: x / 3.0, F), "rdiv": (lambda x: 7.0 / x, F),
    "neg": (lambda x: -x, F), "abs": (lambda x: abs(x), F),
    "min": (lambda x, y: torch.minimum(x, y), F, F),
    "max": (lambda x, y: torch.max(x, y), F, F),
    "clamp": (lambda x: torch.clamp(x, min=-0.5, max=0.5), F),
    "eq": (lambda x, y: x == y, I, I), "ne": (lambda x, y: x != y, F, F),
    "lt": (lambda x, y: x < y, F, F), "le": (lambda x: x <= 0.25, F),
    "gt": (lambda x, y: x > y, I, F), "ge": (lambda x: x >= 1, I),
    "and": (lambda x, y: (x > 0) & (y < 0), F, F),
    "or": (lambda x, y: (x > 0) | y, F, B),
    "xor": (lambda x, y: x ^ y, I, I), "not": (lambda x: ~(x > 1), F),
    "logical": (lambda x, y: torch.logical_and(x, y)
                | torch.logical_not(torch.logical_xor(x, y > 1)), F, F),
    "where": (lambda x, y: torch.where(x > y, x, 0.0), F, F),
    "int_arith": (lambda x, y: torch.maximum(x * y - 3, -x) & 7, I, I),
    "casts": (lambda x, y: x.int() + y.float().to(torch.int32)
              + (x > 0).float().int(), F, I),
    "bool_cast": (lambda x: x.bool(), F),
    "fill": (lambda x: torch.ones_like(x) + torch.full_like(x, 2.0) * x, F),
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_each_op_lowers_and_gives_the_eager_bits(case):
    fn, *dts = OPS[case]
    region, got, want = _one(fn, *dts)
    assert region.status == "lowered", region.status
    assert _same(got[1], want[1]) and _same(got[0], want[0])


@pytest.mark.parametrize("fn,dts,out", [
    (lambda i: i * 2.5, (I,), torch.float32),      # int32 x Python float
    (lambda i, j: i / j, (I, I), torch.float32),   # int / int
    (lambda i: i + 3, (I,), torch.int32),
    (lambda b: b.float() * 2, (B,), torch.float32)])
def test_torch_promotion_is_kept(fn, dts, out):
    region, got, want = _one(fn, *dts)
    assert region.status == "lowered"
    assert got[0].dtype == want[0].dtype == out
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_a_subnormal_constant_is_flushed_with_its_sign():
    region, got, want = _one(lambda x: x * -1e-41, F)
    assert region.status == "lowered"
    prog = region._lowered[-1][1].program
    (mul,) = [i for i in prog.ins if i.op == "mul"]
    assert mul.b < 0 and mul.imm == 0.0 and str(mul.imm) == "-0.0"
    assert _same(got[0], want[0])


def test_a_dict_valued_slot_is_one_leaf_each_and_passes_through():
    q = TStream.source("in", keyed=True).select(
        lambda v: {"s": v["a"] * v["b"], "b": v["b"], "a": v["a"]})
    exe, eager = _both(q.node, 200)
    L = exe.input_specs["in"].length
    rng = np.random.default_rng(3)
    val = {"a": torch.from_numpy(rng.normal(size=(2, L)).astype(np.float32)),
           "b": torch.from_numpy(rng.integers(-5, 5, (2, L)).astype(
               np.int32)),
           "c": torch.zeros(2, L)}
    inp = {"in": (val, torch.from_numpy(rng.random((2, L)) > 0.3))}
    got, want = exe.trace_fn(inp), eager.trace_fn(inp)
    (region,) = exe.regions.by_root.values()
    assert region.status == "lowered"
    low = region._lowered[-1][1]
    assert len(low.program.leaves) == 2          # "c" is never read
    assert len(low.program.outs) == 1            # "a" and "b" pass through
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert got[0]["a"].data_ptr() == want[0]["a"].data_ptr()


def test_a_shifted_read_off_the_grid_is_phi():
    """A planned query whose input grid starts after what the shifted read
    asks for: the first ticks read before the grid, φ in the program as in
    the eager evaluation."""
    s = TStream.source("in")
    root = s.shift(5).select(lambda x: x + 1.0).node
    exe = qc.compile_query(root, 64)
    qp = exe.plan
    (inp_node,) = [n for n in ir.topo_order(exe.root)
                   if isinstance(n, ir.Input)]
    g = qp.plan_of(inp_node)
    plans = dict(qp.node_plans)
    plans[id(inp_node)] = GridPlan(t0=g.t0 + 3, length=g.length - 3,
                                   prec=g.prec)
    short = QueryPlan(root=exe.root, out_len=qp.out_len,
                      out_prec=qp.out_prec, node_plans=plans,
                      input_specs=qp.input_specs)
    lowered = qc.compile_planned(exe.root, short)
    eager = qc.compile_planned(exe.root, short, lower=False)
    L = qp.input_specs["in"].length
    x = torch.arange(L, dtype=torch.float32)
    inp = {"in": (x, torch.ones(L, dtype=torch.bool))}
    got, want = lowered.trace_fn(inp), eager.trace_fn(inp)
    (region,) = lowered.regions.by_root.values()
    assert region.status == "lowered"
    assert not got[1][:3].any() and got[1][3:].all()
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("fn,reason", [
    (lambda x: x % 2, "op:remainder"),
    (lambda x: x + 1 if (x > 0).any() else x - 1, "op:any"),
    (lambda x: x.sum() + x, "op:sum"),
    (lambda x: x + torch.tensor(2.0), "op:tensor")])
def test_a_region_outside_the_op_set_stays_eager_with_its_reason(fn, reason):
    s = TStream.source("in")
    exe, eager = _both(s.select(fn).node, 64)
    L = exe.input_specs["in"].length
    x = torch.linspace(-3, 3, L)
    inp = {"in": (x, torch.ones(L, dtype=torch.bool))}
    got, want = exe.trace_fn(inp), eager.trace_fn(inp)
    (region,) = exe.regions.by_root.values()
    assert region.status == reason
    assert dict(exe.regions.status()) == {reason: 1}
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_python_control_flow_on_a_value_stays_eager():
    """``if x > 0:`` asks a tensor for one bool: the trace stops there, and
    the region runs node by node, which raises as before."""
    exe = qc.compile_query(TStream.source("in").select(
        lambda x: x + 1 if x > 0 else x - 1).node, 64)
    L = exe.input_specs["in"].length
    inp = {"in": (torch.linspace(-3, 3, L), torch.ones(L, dtype=torch.bool))}
    with pytest.raises(RuntimeError, match="ambiguous"):
        exe.trace_fn(inp)
    (region,) = exe.regions.by_root.values()
    assert region.status == "op:__bool__"


def test_a_phi_aware_map_stays_eager():
    exe = qc.compile_query(apps.make_app("impute").query.node, 64)
    assert {r.reason for r in exe.regions.by_root.values()} == {"phi_aware"}


def test_an_unoptimized_dag_lowers_its_chains_too():
    """``opt=False`` takes the DAG as given (the root of a query optimized
    before, as the hold variant of ``shard_map_run`` is built): its
    single-use Map and Where chains lower as the fused regions do, to the
    same bits."""
    app = apps.make_app("qrs")
    data = app.make_input(1 << 11, 2)
    grids = apps.make_grids(data, device="cpu")
    exe = qc.compile_query(app.query.node, 256, opt=False)
    eager = qc.compile_planned(exe.root, exe.plan, lower=False)
    got, want = (partition_run(e, grids, 0, 4) for e in (exe, eager))
    assert dict(exe.regions.status()) == {"lowered": 3}
    assert _same(got.valid, want.valid) and _same(got.value, want.value)


@pytest.mark.parametrize("stages,size,T", [
    (((0, 10),), 10, 10), (((-3, 10),), 10, 10), (((4, 12),), 12, 10),
    (((2, 9), (-5, 7)), 7, 8), (((-20, 5),), 5, 6),
    (((30, 40), (-30, 9)), 9, 12)])
def test_slot_reads_fold_the_stages(stages, size, T):
    """The kernel's five numbers read what the stages read, stage by
    stage, as the plain version does."""
    idx, ok, _ = ref._region_index(stages, size, T)
    S, L, U, lo, hi = rp.slot_reads(stages, size)
    j = np.arange(T)
    assert np.array_equal(np.clip(j + S, L, U), idx)
    assert np.array_equal((j >= lo) & (j < hi), ok)


def test_registers_are_reused_and_loads_come_first():
    region, _, _ = _one(lambda a, b, c, d: (2.0 * a + b - c - 2.0 * d) / 8.0,
                        F, F, F, F)
    prog = region._lowered[-1][1].program
    ops = [i.op for i in prog.ins]
    first = ops.index(next(o for o in ops if o not in ("load", "loadv")))
    assert set(ops[:first]) == {"load", "loadv"}
    assert "load" not in ops[first:] and "loadv" not in ops[first:]
    assert prog.n_regs <= 8 < len(prog.ins)


@pytest.mark.parametrize("name,regions", [("qrs", 3), ("ysb", 1)])
def test_runner_gauges_count_the_lowered_regions(name, regions):
    """The plan-time gauges beside the runner's ``eval_trim_pct``: every
    region of the benchmark's queries lowered, none left eager."""
    K, segs = 3, 2
    if name == "ysb":
        exe = qc.compile_query(
            apps.make_keyed_app("ysb", win=1000).query.node, 1)
    else:
        exe = qc.compile_query(apps.make_keyed_app("qrs").query.node, 128)
    r = Runner(exe, ExecPolicy(keys="vmapped"), n_keys=K,
               segs_per_chunk=segs)
    span = r.spec.input_specs["in"].core * segs
    rng = np.random.default_rng(5)
    vals = ({"etype": rng.integers(0, 3, (K, span)).astype(np.float32)}
            if name == "ysb" else
            rng.integers(-1024, 1024, (K, span)).astype(np.float32))
    r.step({"in": keyed_grid(vals, np.ones((K, span), bool), device="cpu")})
    gauges = r.metrics.snapshot()["gauges"]
    assert gauges["runner.regions_lowered"]["value"] == regions
    assert not [k for k in gauges if k.startswith("runner.regions_eager")]
