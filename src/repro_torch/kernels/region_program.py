"""One launch for an elementwise region: a wrapper around the CUDA source
``csrc/region_program.cu``.

It replaces no TPU kernel: XLA fuses the reference's elementwise ops
into one loop by itself, where PyTorch runs each torch call of a region
as a kernel of its own, one pass over device memory each.
:mod:`repro_torch.core.region` lowers each elementwise region of a planned
query into a :class:`Program`: its loads (each slot's validity and the
value leaves it reads; a slot is one read of a node's ``(value, valid)``
at a fixed tick offset), then a straight line of instructions over a few
registers.  One launch of the kernel reads each slot once a tick, runs the
instructions, and writes the computed values and the validity once.

Each instruction rounds as the torch call it was recorded from does on
the card (separate roundings, no FMA contraction; a division by a
constant is the product with its reciprocal, as PyTorch's CUDA division
by a scalar is), so a launch gives the bits of the eager calls.  The
plain version is :func:`repro_torch.kernels.ref.region_program_ref`, which
replays the same calls; a CPU tensor runs it, a CUDA tensor launches the
kernel or raises.  ``launches`` counts the launches that reached the card;
``copies`` counts inputs made contiguous first.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import ref as _ref
from .build import launch_stream, library

__all__ = ["Ins", "Program", "OPS", "DTYPES", "F32", "I32", "BOOL",
           "MAX_INS", "MAX_LOADS", "MAX_OUTS", "MAX_REGS",
           "region_program", "slot_reads", "launches", "copies",
           "reset_launches"]

launches = {"region_program": 0}
# inputs the wrapper made contiguous (rows of one stride) before its launch
copies = {"region_program": 0}

# The kernel's limits and geometry, as in csrc/region_program.cu (checked
# against the library when it is first used).
MAX_INS = 64          # instructions after the loads
MAX_LOADS = 32        # loads: each slot's validity and each leaf read
MAX_OUTS = 4
MAX_REGS = 12
TILE = 512            # ticks of a row a block runs

# register dtypes, by code
F32, I32, BOOL = 0, 1, 2
DTYPES = (torch.float32, torch.int32, torch.bool)

# opcodes, by code (the order of csrc/region_program.cu's enum)
OPS = ("load", "loadv", "const", "cast", "add", "sub", "mul", "div", "divc",
       "recip", "neg", "abs", "min", "max", "eq", "ne", "lt", "le", "gt",
       "ge", "and", "or", "xor", "not", "where")
_CODE = {name: i for i, name in enumerate(OPS)}


class Ins(NamedTuple):
    """One instruction: ``dst = op(a, b, c)`` computed in dtype ``dt``.

    ``load``: ``a`` the program's leaf; ``loadv``: ``a`` the slot (its
    validity and its ticks in range); ``const``: ``imm`` the value;
    ``cast``: ``imm`` the source dtype's code; ``divc``: ``a / imm``.  A
    binary op with ``b < 0`` takes ``imm`` as its second operand.
    Comparisons compare in ``dt`` and give a bool."""
    op: str
    dt: int
    dst: int
    a: int = -1
    b: int = -1
    c: int = -1
    imm: object = 0


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered region: output tick ``j`` of every row runs ``ins`` with
    each slot read at its own tick.

    ``slots``: per slot its stages ``((start, length), ...)``, root first:
    the index entering a stage becomes ``start + index``, in range where
    it lies in ``[0, length)`` and clamped into it (the last stage clamps
    to the length of the tensor read, as an out-of-range ``take`` does).
    ``leaves``: per loaded value leaf ``(slot, leaf index in the slot's
    flattened value, dtype code)``.  ``outs``: ``(register, dtype code)``
    of each value the launch writes; ``ok``: the validity's register."""
    length: int
    slots: tuple
    leaves: tuple
    ins: tuple
    n_regs: int
    outs: tuple
    ok: int


def reset_launches() -> None:
    """Zero ``launches`` and ``copies``."""
    for counts in (launches, copies):
        for k in counts:
            counts[k] = 0


# -- the kernel's parameter, field for field as in the CUDA source ----------

class _Load(ctypes.Structure):
    _fields_ = [("row0", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                ("S", ctypes.c_int), ("L", ctypes.c_int), ("U", ctypes.c_int),
                ("lo", ctypes.c_int), ("hi", ctypes.c_int),
                ("dst", ctypes.c_int), ("bytes", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _Ins(ctypes.Structure):
    _fields_ = [("op", ctypes.c_uint8), ("dt", ctypes.c_uint8),
                ("pad0", ctypes.c_uint8), ("pad1", ctypes.c_uint8),
                ("dst", ctypes.c_int16), ("a", ctypes.c_int16),
                ("b", ctypes.c_int16), ("c", ctypes.c_int16),
                ("imm", ctypes.c_uint32)]


class _Out(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                ("reg", ctypes.c_int), ("dt", ctypes.c_int)]


class _Prog(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_longlong), ("cols", ctypes.c_longlong),
                ("tiles", ctypes.c_longlong), ("vout", ctypes.c_void_p),
                ("vstride", ctypes.c_longlong), ("n_loads", ctypes.c_int),
                ("n_ops", ctypes.c_int), ("n_outs", ctypes.c_int),
                ("ok", ctypes.c_int), ("n_regs", ctypes.c_int),
                ("pad", ctypes.c_int), ("loads", _Load * MAX_LOADS),
                ("ops", _Ins * MAX_INS), ("outs", _Out * MAX_OUTS)]


def _imm_bits(ins: Ins) -> int:
    """The instruction's 32-bit immediate: for ``divc`` the bits of the
    divisor's f32 reciprocal, which is what PyTorch's CUDA division by a
    scalar multiplies with; for ``cast`` the source dtype's code; else a
    constant's bits in the instruction's dtype.  Numpy, not torch: this
    runs inside a step the analysis records, where a torch call would
    show."""
    if ins.op == "divc":
        r = np.float32(1.0) / np.float32(ins.imm)
        return int(np.array(r, np.float32).view(np.uint32))
    if ins.op == "cast" or ins.dt == BOOL:
        return int(ins.imm)
    t = np.array(ins.imm, np.float32 if ins.dt == F32 else np.int32)
    return int(t.view(np.uint32))


@functools.lru_cache(maxsize=256)
def _template(prog: Program) -> _Prog:
    """The launch parameter of ``prog`` without its pointers, strides and
    reads: what every launch of it shares."""
    p = _Prog()
    loads = [i for i in prog.ins if i.op in ("load", "loadv")]
    ops = prog.ins[len(loads):]
    p.n_loads, p.n_ops, p.n_outs = len(loads), len(ops), len(prog.outs)
    p.ok, p.n_regs = prog.ok, prog.n_regs
    for d, ins in zip(p.loads, loads):
        d.dst = ins.dst
        d.bytes = ins.op == "loadv" or prog.leaves[ins.a][2] == BOOL
    for i, (reg, dt) in enumerate(prog.outs):
        p.outs[i].reg, p.outs[i].dt = reg, dt
    for c, ins in zip(p.ops, ops):
        c.op, c.dt, c.dst = _CODE[ins.op], ins.dt, ins.dst
        c.a, c.b, c.c = ins.a, ins.b, ins.c
        c.imm = _imm_bits(ins)
    return p


_lib = None


def _program_lib():
    """The kernel library, its limits and parameter layout checked against
    this module's at the first call."""
    global _lib
    if _lib is None:
        lib = library.load()
        got = (lib.rp_tile(), lib.rp_limits(), lib.rp_param_bytes())
        want = (TILE, _limits(), ctypes.sizeof(_Prog))
        if got != want:
            raise RuntimeError(f"region_program: kernel geometry {got} != "
                               f"the wrapper's {want}")
        _lib = lib
    return _lib


def _limits() -> int:
    """The kernel's limits packed in one integer (``rp_limits``)."""
    return ((MAX_INS * 64 + MAX_LOADS) * 64 + MAX_OUTS) * 64 + MAX_REGS


def slot_reads(stages, size: int) -> tuple:
    """A slot's stages folded into ``(S, L, U, lo, hi)``: output tick ``j``
    reads tick ``min(max(j + S, L), U)`` of a row of ``size`` ticks and
    lies in range where ``lo <= j < hi``.

    Each stage maps the tick entering it to ``start + tick``, in range in
    ``[0, length)``, clamped into it (the last into ``[0, size)``, as the
    eager ``take`` clamps), and a clamp of a clamp is a clamp, so the
    whole path is one.  Where every stage before it is in range, a stage
    sees ``j`` plus the starts before it, so the ticks in range are one
    interval."""
    S, L, U = 0, None, None
    lo, hi = -2**31, 2**31 - 1
    for k, (start, length) in enumerate(stages):
        top = (size if k == len(stages) - 1 else length) - 1
        S += start
        L = 0 if L is None else min(max(L + start, 0), top)
        U = top if U is None else min(max(U + start, 0), top)
        lo, hi = max(lo, -S), min(hi, length - S)
    return S, L, U, lo, max(lo, hi)


def _rows(t: torch.Tensor, R: int) -> torch.Tensor:
    """``t`` as ``(R, T)`` rows with contiguous ticks: a view where there
    is one, else a copy, counted."""
    T = t.shape[-1]
    if T == 1 or t.stride(-1) == 1:
        try:
            return t.view(R, T)
        except RuntimeError:    # the leading axes do not fold into rows
            pass
    copies["region_program"] += 1
    return t.contiguous().view(R, T)


def region_program(prog: Program, valids, leaves):
    """Run ``prog`` over every row: ``valids`` the slots' validities and
    ``leaves`` the loaded value leaves, each ``(*B, T_s)`` with one leading
    shape ``B`` and, per slot, one ``T_s``.  Returns ``(outs, valid)``:
    the computed values (``(*B, prog.length)``, one per ``prog.outs``) and
    the validity ``(*B, prog.length)`` bool."""
    dev = valids[0].device
    if dev.type == "cpu":
        return _ref.region_program_ref(prog, valids, leaves)
    if dev.type != "cuda" or any(t.device != dev for t in (*valids,
                                                            *leaves)):
        raise ValueError("region_program: kernel takes CUDA tensors on one "
                         "device")
    lead = valids[0].shape[:-1]
    if any(t.shape[:-1] != lead for t in (*valids, *leaves)):
        raise ValueError("region_program: inputs of one leading shape, got "
                         f"{[tuple(t.shape) for t in (*valids, *leaves)]}")
    if any(v.dtype != torch.bool for v in valids) or any(
            x.dtype != DTYPES[dt] for x, (_, _, dt) in zip(leaves,
                                                          prog.leaves)):
        raise TypeError("region_program: input dtypes differ from the "
                        "program's")
    T = prog.length
    shape = lead + (T,)
    outs = [torch.empty(shape, dtype=DTYPES[dt], device=dev)
            for _, dt in prog.outs]
    vout = torch.empty(shape, dtype=torch.bool, device=dev)
    R = math.prod(lead)
    if R == 0 or T == 0:
        return outs, vout
    tiles = -(-T // TILE)
    if tiles >= 2**31 or max(v.shape[-1] for v in valids) >= 2**31:
        raise ValueError(f"region_program: rows of {T} ticks exceed the "
                         "grid")
    lib = _program_lib()
    p = _Prog.from_buffer_copy(_template(prog))
    p.rows, p.cols, p.tiles = R, T, tiles
    p.vout, p.vstride = vout.data_ptr(), T
    # the rows stay referenced until the launch is enqueued
    vrows = [_rows(v, R) for v in valids]
    xrows = [_rows(x, R) for x in leaves]
    loads = [i for i in prog.ins if i.op in ("load", "loadv")]
    for d, ins in zip(p.loads, loads):
        if ins.op == "loadv":
            k, x, width = ins.a, vrows[ins.a], 1
        else:
            k, x = prog.leaves[ins.a][0], xrows[ins.a]
            width = x.element_size()
        d.row0, d.stride = x.data_ptr(), x.stride(0) * width
        d.S, d.L, d.U, lo, hi = slot_reads(prog.slots[k], x.shape[-1])
        # a value keeps its clamped read out of range, as the eager take
        d.lo, d.hi = (lo, hi) if ins.op == "loadv" else (-2**31, 2**31 - 1)
    for i, o in enumerate(outs):
        p.outs[i].ptr, p.outs[i].stride = o.data_ptr(), T
    err = lib.rp_region_program(ctypes.addressof(p), dev.index,
                                launch_stream(dev))
    if err != 0:
        raise RuntimeError(f"region_program: CUDA launch failed with error "
                           f"{err}")
    launches["region_program"] += 1
    return outs, vout
