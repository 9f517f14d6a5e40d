"""Elementwise regions of a planned query, each run as one program: the
loop fusion of the TiLT paper's backend (§6).

:func:`repro_torch.core.fusion.fuse_elemwise` collapses every maximal
elementwise region of the DAG into one fused ``Map`` (with a ``Where``
gate and an unwrap where the region filters), and eager evaluation still
runs that closure as one kernel per torch call, plus one per validity AND
and one per shifted read.  :func:`lower` finds, in an optimized and
planned query, each region: a ``Map`` or ``Where`` root with the
single-use elementwise nodes of its precision above it and the
single-use ``Shift`` nodes between them and what they read.  The nodes
it reads are its *sources*; each path from the root to a source is a
*slot*, read at one tick offset.

A region runs as one :class:`repro_torch.kernels.region_program.Program`
(one launch on the card) when

* every align on its paths is affine with step 1, so a slot's tick and
  whether it lies in range are index arithmetic (else ``align``);
* its user functions, traced once per input signature (the sources'
  value pytrees and dtypes) on one-element probes under a
  :class:`~torch.overrides.TorchFunctionMode`, make only calls of the
  program's op set, with torch's own type promotion and the subnormal
  flush of :func:`repro_torch.core.compile._user` (else ``op:<name>``, or
  ``dtype`` for a leaf read in a dtype the program has not);
* its sources share one leading shape (else ``shape``) and it fits the
  kernel's limits (else ``size``).

A ``Map`` that is φ-aware keeps its own evaluation (``phi_aware``).  Where
a region does not lower it is evaluated node by node, as before; which
way a region goes is fixed by what the plan and the first inputs of a
signature show, never by a launch that failed.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import compile as _qc
from . import fusion, ir
from ..kernels import region_program as kr

__all__ = ["Region", "Regions", "lower"]

_CODES = {torch.float32: kr.F32, torch.int32: kr.I32, torch.bool: kr.BOOL}


class _Eager(Exception):
    """The region stays eager; the argument says why."""


# ---------------------------------------------------------------------------
# the tracer: torch calls of the user functions -> instructions
# ---------------------------------------------------------------------------

def _const(x, dt: int):
    """A Python constant as the program holds it in dtype ``dt``."""
    if dt == kr.F32:
        return float(np.float32(x))
    if dt == kr.BOOL:
        return bool(x)
    if isinstance(x, float) or not -2**31 <= int(x) < 2**31:
        raise _Eager("op:const")
    return int(x)


class _Trace(TorchFunctionMode):
    """Records the torch calls made on the probes as instructions, with
    one virtual register a value."""

    def __init__(self):
        super().__init__()
        self.ins: list = []
        self.dtype: list = []            # virtual register -> dtype code
        self.reg: Dict[int, int] = {}    # id(tensor) -> virtual register
        self.loads: Dict[int, tuple] = {}  # id(probe) -> (slot, leaf, dtype)
        self.leaves: list = []           # the program's loaded leaves
        self.keep: list = []             # traced tensors, so ids stay unique
        self.memo: dict = {}             # constants and casts made once

    def emit(self, op: str, dt: int, a=-1, b=-1, c=-1, imm=0,
             res: Optional[int] = None) -> int:
        """A new register ``op(a, b, c)``, computed in ``dt``, of dtype
        ``res`` (``dt`` but for a comparison's bool)."""
        dst = len(self.dtype)
        self.dtype.append(dt if res is None else res)
        self.ins.append(kr.Ins(op, dt, dst, a, b, c, imm))
        return dst

    def probe(self, slot: int, leaf: int, x: torch.Tensor) -> torch.Tensor:
        t = torch.ones(1, dtype=x.dtype)
        self.keep.append(t)
        self.loads[id(t)] = (slot, leaf, x.dtype)
        return t

    def value(self, t: torch.Tensor) -> int:
        """The register of a traced tensor; a probe is loaded at its first
        use."""
        r = self.reg.get(id(t))
        if r is not None:
            return r
        if id(t) not in self.loads:
            raise _Eager("op:tensor")   # a tensor the region did not read
        slot, leaf, dtype = self.loads[id(t)]
        if dtype not in _CODES:
            raise _Eager("dtype")
        self.leaves.append((slot, leaf, _CODES[dtype]))
        r = self.reg[id(t)] = self.emit("load", _CODES[dtype],
                                        len(self.leaves) - 1)
        return r

    def operand(self, x, dt: int) -> int:
        """``x`` (a traced tensor or a Python number) as a register of
        dtype ``dt``."""
        if torch.is_tensor(x):
            r = self.value(x)
            if self.dtype[r] == dt:
                return r
            key = ("cast", r, dt)
            if key not in self.memo:
                self.memo[key] = self.emit("cast", dt, r,
                                           imm=self.dtype[r])
            return self.memo[key]
        if not isinstance(x, (bool, int, float)):
            raise _Eager("op:operand")
        v = _const(x, dt)
        key = ("const", dt, repr(v))
        if key not in self.memo:
            self.memo[key] = self.emit("const", dt, imm=v)
        return self.memo[key]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "__get__":          # a tensor property
            prop = getattr(getattr(func, "__self__", None), "__name__", "")
            if prop in ("dtype", "device"):
                return func(*args, **kwargs)
            raise _Eager(f"op:{prop}")
        handler = _HANDLERS.get(name)
        if handler is None:
            raise _Eager(f"op:{name}")
        dt = next((a.dtype for a in (*args, *kwargs.values())
                   if torch.is_tensor(a) and a.dim() > 0
                   and a.is_floating_point()), None)
        if dt is not None:             # as _qc._FlushSubnormal
            args = tuple(_qc._flush(a, dt) for a in args)
            kwargs = {k: _qc._flush(v, dt) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if not torch.is_tensor(out) or out.dtype not in _CODES:
            raise _Eager(f"op:{name}")
        if id(out) in self.reg or id(out) in self.loads:
            return out                 # a cast to the dtype it has
        self.keep.append(out)
        self.reg[id(out)] = handler(self, func, out, args, kwargs)
        return out


def _args(args, kwargs, names):
    """The operands named ``names``, positional or by keyword."""
    out = list(args) + [None] * (len(names) - len(args))
    for i, n in enumerate(names):
        if n in kwargs:
            out[i] = kwargs[n]
    return out[:len(names)]


def _arith(op, reverse=False):
    def h(tr, func, out, args, kwargs):
        if kwargs.get("alpha", 1) != 1 or kwargs.get("rounding_mode"):
            raise _Eager(f"op:{func.__name__}")
        a, b = _args(args, kwargs, ("input", "other"))
        if reverse:
            a, b = b, a
        dt = _CODES[out.dtype]
        if dt == kr.BOOL:
            raise _Eager(f"op:{func.__name__}")
        if op == "div" and not torch.is_tensor(b):
            return tr.emit("divc", dt, tr.operand(a, dt),
                           imm=_const(b, kr.F32))
        return tr.emit(op, dt, tr.operand(a, dt), tr.operand(b, dt))
    return h


def _rdiv(tr, func, out, args, kwargs):
    """``c / x``: torch's ``reciprocal(x) * c``."""
    x, c = args
    dt = _CODES[out.dtype]
    r = tr.emit("recip", dt, tr.operand(x, dt))
    return tr.emit("mul", dt, r, tr.operand(c, dt))


def _compare(op):
    def h(tr, func, out, args, kwargs):
        a, b = _args(args, kwargs, ("input", "other"))
        dt = _CODES.get(torch.result_type(a, b))
        if dt is None:
            raise _Eager(f"op:{func.__name__}")
        return tr.emit(op, dt, tr.operand(a, dt), tr.operand(b, dt),
                       res=kr.BOOL)
    return h


def _minmax(op):
    def h(tr, func, out, args, kwargs):
        if len(args) != 2 or kwargs or not torch.is_tensor(args[1]):
            raise _Eager(f"op:{func.__name__}")   # a reduction
        dt = _CODES[out.dtype]
        return tr.emit(op, dt, tr.operand(args[0], dt),
                       tr.operand(args[1], dt))
    return h


def _clamp(tr, func, out, args, kwargs):
    x, lo, hi = _args(args, kwargs, ("input", "min", "max"))
    if func.__name__ == "clamp_max":
        lo, hi = None, lo
    dt = _CODES[out.dtype]
    r = tr.operand(x, dt)
    if lo is not None:
        r = tr.emit("max", dt, r, tr.operand(lo, dt))
    if hi is not None:
        r = tr.emit("min", dt, r, tr.operand(hi, dt))
    return r


def _bitwise(op, logical=False):
    def h(tr, func, out, args, kwargs):
        dt = kr.BOOL if logical else _CODES[out.dtype]
        if dt == kr.F32:
            raise _Eager(f"op:{func.__name__}")
        ops = [tr.operand(a, dt) for a in _args(
            args, kwargs, ("input", "other")[:2 if op != "not" else 1])]
        return tr.emit(op, dt, *ops)
    return h


def _unary(op):
    def h(tr, func, out, args, kwargs):
        dt = _CODES[out.dtype]
        if dt == kr.BOOL:
            raise _Eager(f"op:{func.__name__}")
        return tr.emit(op, dt, tr.operand(args[0], dt))
    return h


def _where(tr, func, out, args, kwargs):
    if func is torch.Tensor.where:
        x, cond, y = _args(args, kwargs, ("input", "condition", "other"))
    else:
        cond, x, y = _args(args, kwargs, ("condition", "input", "other"))
    dt = _CODES[out.dtype]
    return tr.emit("where", dt, tr.operand(cond, kr.BOOL),
                   tr.operand(x, dt), tr.operand(y, dt))


def _cast(tr, func, out, args, kwargs):
    if func.__name__ == "to":
        rest = [a for a in args[1:] if not isinstance(a, torch.dtype)]
        if rest or set(kwargs) - {"dtype"}:
            raise _Eager("op:to")
    return tr.operand(args[0], _CODES[out.dtype])


def _fill(value):
    def h(tr, func, out, args, kwargs):
        if func.__name__ == "full_like":
            v = _args(args, kwargs, ("input", "fill_value"))[1]
        else:
            v = value
        return tr.operand(v, _CODES[out.dtype])
    return h


_HANDLERS = {}
for _names, _h in (
        (("add", "__add__", "__radd__"), _arith("add")),
        (("sub", "__sub__", "subtract"), _arith("sub")),
        (("__rsub__", "rsub"), _arith("sub", reverse=True)),
        (("mul", "__mul__", "__rmul__", "multiply"), _arith("mul")),
        (("div", "__truediv__", "true_divide", "divide"), _arith("div")),
        (("__rdiv__", "__rtruediv__"), _rdiv),
        (("neg", "__neg__", "negative"), _unary("neg")),
        (("abs", "__abs__", "absolute"), _unary("abs")),
        (("minimum", "min"), _minmax("min")),
        (("maximum", "max"), _minmax("max")),
        (("clamp", "clip", "clamp_min", "clamp_max"), _clamp),
        (("eq", "__eq__"), _compare("eq")),
        (("ne", "__ne__", "not_equal"), _compare("ne")),
        (("lt", "__lt__", "less"), _compare("lt")),
        (("le", "__le__", "less_equal"), _compare("le")),
        (("gt", "__gt__", "greater"), _compare("gt")),
        (("ge", "__ge__", "greater_equal"), _compare("ge")),
        (("__and__", "__rand__", "bitwise_and"), _bitwise("and")),
        (("__or__", "__ror__", "bitwise_or"), _bitwise("or")),
        (("__xor__", "__rxor__", "bitwise_xor"), _bitwise("xor")),
        (("__invert__", "bitwise_not"), _bitwise("not")),
        (("logical_and",), _bitwise("and", logical=True)),
        (("logical_or",), _bitwise("or", logical=True)),
        (("logical_xor",), _bitwise("xor", logical=True)),
        (("logical_not",), _bitwise("not", logical=True)),
        (("where",), _where),
        (("float", "int", "bool", "to"), _cast),
        (("ones_like",), _fill(1)), (("zeros_like",), _fill(0)),
        (("full_like",), _fill(None))):
    for _n in _names:
        _HANDLERS[_n] = _h


_NO_REGS = ("load", "loadv", "const")   # operands that are not registers
_BINARY = frozenset({"add", "sub", "mul", "div", "min", "max", "eq", "ne",
                     "lt", "le", "gt", "ge", "and", "or", "xor"})


def _reads(x: kr.Ins) -> tuple:
    if x.op in _NO_REGS:
        return ()
    return tuple(r for r in (x.a, x.b, x.c) if r >= 0)


def _schedule(ins: list, live_out: set) -> tuple:
    """The traced instructions as the kernel runs them: a constant second
    operand made an immediate, what does not reach ``live_out`` dropped,
    every load first (so a warp has them all in flight before it first
    waits), then physical registers, each free again once its last read
    is issued (an instruction may write the register it reads last: the
    kernel reads a tick's operands before it writes).  Returns
    ``(instructions, registers used, virtual -> physical)``."""
    consts = {x.dst: x.imm for x in ins if x.op == "const"}
    ins = [x._replace(b=-1, imm=consts[x.b])
           if x.op in _BINARY and x.b in consts else x for x in ins]
    need, kept = set(live_out), []
    for x in reversed(ins):
        if x.dst in need:
            kept.append(x)
            need.update(_reads(x))
    kept.reverse()
    kept.sort(key=lambda x: x.op not in ("load", "loadv"))   # stable
    last: Dict[int, int] = {}
    for i, x in enumerate(kept):
        for r in _reads(x):
            last[r] = i
    phys: Dict[int, int] = {}
    free: list = []
    out, n = [], 0
    for i, x in enumerate(kept):
        ops = {f: phys[getattr(x, f)] for f in "abc"
               if x.op not in _NO_REGS and getattr(x, f) >= 0}
        for r in set(_reads(x)):
            if last[r] == i and r not in live_out:
                free.append(phys[r])
        if free:
            phys[x.dst] = free.pop()
        else:
            phys[x.dst], n = n, n + 1
        out.append(x._replace(dst=phys[x.dst], **ops))
    return out, n, phys


# ---------------------------------------------------------------------------
# regions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Lowered:
    program: kr.Program
    out_spec: object        # the value's treespec
    out_leaves: tuple       # per value leaf: ("out", i) or ("slot", k, leaf)


class Region:
    """One elementwise region of a planned query: its root, the nodes it
    reads (``sources``), its slots and, per input signature, its program
    or why it stays eager (:attr:`status`)."""

    def __init__(self, root: ir.Node, length: int, sources=(), slots=(),
                 tree=None, reason: Optional[str] = None):
        self.root = root
        self.length = length
        self.sources = tuple(sources)
        self.slots = tuple(slots)   # (source index, stages, align specs)
        self.tree = tree
        self.reason = reason
        self._lowered: list = []    # [(signature, _Lowered | reason)]
        self.status = reason        # the latest outcome; None: not yet run

    def _signature(self, args) -> tuple:
        flat = [tree_flatten(v) for v, _ in args]
        lead = args[0][1].shape[:-1]
        same = all(m.shape[:-1] == lead and all(
            x.shape == m.shape for x in leaves)
            for (leaves, _), (_, m) in zip(flat, args))
        return tuple((spec, tuple(x.dtype for x in leaves))
                     for leaves, spec in flat) + (same,), flat

    def run(self, args) -> Optional[tuple]:
        """The root's ``(value, valid)`` from the sources' ``args``, or
        None where this signature stays eager."""
        if self.reason is not None:
            return None
        sig, flat = self._signature(args)
        low = next((lw for s, lw in self._lowered if s == sig), None)
        if low is None:
            low = self._lower(flat, sig[-1])
            self._lowered.append((sig, low))
        self.status = "lowered" if isinstance(low, _Lowered) else low
        if not isinstance(low, _Lowered):
            return None
        prog = low.program
        valids = [args[src][1] for src, _, _ in self.slots]
        leaves = [flat[self.slots[k][0]][0][li] for k, li, _ in prog.leaves]
        outs, valid = kr.region_program(prog, valids, leaves)
        vals = []
        for leaf in low.out_leaves:
            if leaf[0] == "out":
                vals.append(outs[leaf[1]])
                continue
            _, k, li = leaf
            src, _, specs = self.slots[k]
            x = flat[src][0][li]
            for sp in reversed(specs):
                x = sp.take(x)
            vals.append(x)
        return tree_unflatten(vals, low.out_spec), valid

    def _lower(self, flat, same: bool):
        """The program for one signature, or why it stays eager."""
        if not same:
            return "shape"
        tr = _Trace()
        terms: list = []

        def ev(t):
            if t[0] == "slot":
                return probes[t[1]]
            if t[0] == "map":
                return t[1].fn(*[ev(s) for s in t[2]])
            v = ev(t[2])
            terms.append(t[1].pred(v))
            return v

        # an outer dispatch mode (a step being recorded) sees no probe
        with _disable_current_modes():
            probes = [tree_unflatten([tr.probe(k, i, x) for i, x in
                                      enumerate(flat[src][0])],
                                     flat[src][1])
                      for k, (src, _, _) in enumerate(self.slots)]
            try:
                with tr:
                    v = ev(self.tree)
                leaves, spec = tree_flatten(v)
                out_leaves, outs = [], []
                for x in leaves:
                    if not torch.is_tensor(x):
                        raise _Eager("op:output")
                    if id(x) in tr.loads:      # a value passed through
                        k, li, _ = tr.loads[id(x)]
                        out_leaves.append(("slot", k, li))
                        continue
                    out = (tr.value(x), _CODES[x.dtype])
                    if out not in outs:
                        outs.append(out)
                    out_leaves.append(("out", outs.index(out)))
                ok = None
                for k in range(len(self.slots)):
                    r = tr.emit("loadv", kr.BOOL, k)
                    ok = r if ok is None else tr.emit("and", kr.BOOL, ok, r)
                for term in terms:
                    if not torch.is_tensor(term) or term.dtype != torch.bool:
                        raise _Eager("op:pred")
                    ok = tr.emit("and", kr.BOOL, ok, tr.value(term))
            except _Eager as e:
                return str(e)
        live = {r for r, _ in outs} | {ok}
        ins, n_regs, phys = _schedule(tr.ins, live)
        n_loads = len(tr.leaves) + len(self.slots)
        if (len(ins) - n_loads > kr.MAX_INS or n_loads > kr.MAX_LOADS
                or n_regs > kr.MAX_REGS or len(outs) > kr.MAX_OUTS):
            return "size"
        prog = kr.Program(
            length=self.length,
            slots=tuple(stages for _, stages, _ in self.slots),
            leaves=tuple(tr.leaves), ins=tuple(ins), n_regs=n_regs,
            outs=tuple((phys[r], dt) for r, dt in outs), ok=phys[ok])
        return _Lowered(prog, spec, tuple(out_leaves))


class Regions:
    """The regions of one planned query, by the id of their root."""

    def __init__(self, regions: Dict[int, Region]):
        self.by_root = regions

    def get(self, n: ir.Node) -> Optional[Region]:
        return self.by_root.get(id(n))

    def status(self) -> collections.Counter:
        """Regions by outcome: ``lowered``, or the reason a region stays
        eager; a region no input has reached yet is not counted."""
        return collections.Counter(r.status for r in self.by_root.values()
                                   if r.status is not None)


def _stage(spec) -> tuple:
    affine, start, step = spec._affine
    if not affine or (spec.out.length > 1 and step != 1):
        raise _Eager("align")
    return start, spec.arg.length, spec.exact


def _stages(chain) -> tuple:
    """A path's stages with every stage that reads only in range folded
    into the next one (its offset added, no clamp to do)."""
    out, off = [], 0
    for k, (start, length, exact) in enumerate(chain):
        if exact and k < len(chain) - 1:
            off += start
            continue
        out.append((off + start, length))
        off = 0
    return tuple(out)


def _region(n: ir.Node, qp, counts: dict, member: set) -> Region:
    length = qp.plan_of(n).length
    if isinstance(n, ir.Map) and n.phi_aware:
        return Region(n, length, reason="phi_aware")
    sources: list = []
    slots: list = []
    source_of: dict = {}     # id(node) -> source index
    slot_of: dict = {}       # (source index, stages) -> slot index

    def absorbed(a: ir.Node) -> bool:
        if counts.get(id(a), 0) != 1:
            return False
        if isinstance(a, ir.Shift):
            affine, _, step = qp.align(a.args[0], a, delta=a.delta)._affine
            return bool(affine) and (qp.plan_of(a).length <= 1 or step == 1)
        return fusion._is_elemwise(a) and a.prec == n.prec

    def visit(a: ir.Node, chain: tuple, specs: tuple):
        if absorbed(a):
            member.add(id(a))
            return build(a, chain, specs)
        if id(a) not in source_of:
            source_of[id(a)] = len(sources)
            sources.append(a)
        key = (source_of[id(a)], _stages(chain))
        if key not in slot_of:
            slot_of[key] = len(slots)
            slots.append((*key, specs))
        return ("slot", slot_of[key])

    def read(a, x, chain, specs, delta=0):
        sp = qp.align(a, x, delta=delta)
        return visit(a, chain + (_stage(sp),), specs + (sp,))

    def build(x: ir.Node, chain: tuple, specs: tuple):
        if isinstance(x, ir.Shift):
            return read(x.args[0], x, chain, specs, x.delta)
        subs = [read(a, x, chain, specs) for a in x.args]
        if isinstance(x, ir.Where):
            return ("where", x, subs[0])
        return ("map", x, subs)

    try:
        tree = build(n, (), ())
    except _Eager as e:
        return Region(n, length, reason=str(e))
    if len(slots) > kr.MAX_LOADS:
        return Region(n, length, reason="size")
    return Region(n, length, sources, slots, tree)


def lower(root: ir.Node, qp) -> Regions:
    """Every elementwise region of the planned query ``root``: a region
    for each ``Map`` or ``Where`` that no region above it absorbs."""
    counts = fusion._use_counts(root)
    member: set = set()
    regions: Dict[int, Region] = {}
    for n in reversed(ir.topo_order(root)):
        if id(n) not in member and isinstance(n, (ir.Map, ir.Where)):
            regions[id(n)] = _region(n, qp, counts, member)
    return Regions(regions)
