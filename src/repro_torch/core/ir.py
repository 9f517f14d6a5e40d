"""TiLT intermediate representation (paper §4); port of ``repro.core.ir``.

A streaming query is a DAG of :class:`Node` objects, each defining an output
*temporal object* as a functional transformation of its inputs over a time
domain ``TDom(Ts, Te, prec)`` (paper §4.1).  The node vocabulary is the
minimal set the paper identifies:

* :class:`Input`    — a source temporal object (``~stock``).
* :class:`Const`    — a constant temporal object (always valid).
* :class:`Map`      — elementwise functional transformation of one or more
                      temporal objects at the *same* time instant.  Covers
                      Select and temporal Join (binary Map with strict-overlap
                      φ semantics) from Fig. 1/4.
* :class:`Where`    — conditional nulling: value passes through, validity is
                      ANDed with a predicate (Fig. 4 ``~where``).
* :class:`Shift`    — time shift: ``out[t] = in[t - delta]``.
* :class:`Reduce`   — ``⊕(op, ~in[t-window : t])`` on a (possibly strided)
                      output domain: sliding/tumbling window aggregation.
* :class:`Interp`   — gap fill (imputation/resampling support): values at
                      invalid ticks are reconstructed from neighbours within
                      a bounded ``max_gap`` (hold / linear interpolation).

φ-semantics (paper eq. 1): every node computes a ``(value, valid)`` pair per
tick; arithmetic on φ yields φ, hence ``Map.valid = AND(arg valids)``;
``Reduce`` folds only valid ticks and yields φ on empty windows.

Precision & alignment: each node carries ``prec``.  A node with precision
``q`` reads an argument with precision ``p`` at output time ``τ`` using the
snapshot *hold* rule (stream.py): arg tick ``(τ - t0)//p - 1``.  The frontend
enforces ``p | q`` or ``q | p`` so alignment is a static gather.

Time is left symbolic: nodes never store ``Ts``/``Te``.  Boundary resolution
(boundary.py) turns the infinite domain into a partition contract, and
compile.py instantiates the query on concrete grids — this mirrors the
paper's Fig. 3(a→b) pipeline.
"""
from __future__ import annotations

import dataclasses
import dis
import functools
import hashlib
import itertools
import types
from typing import Any, Callable, Optional, Sequence

__all__ = [
    "Node", "Input", "Const", "Map", "Where", "Shift", "Reduce", "Interp",
    "topo_order", "topo_order_multi", "free_inputs", "validate",
    "fingerprint",
]

_ids = itertools.count()


@dataclasses.dataclass(frozen=True, eq=False)
class Node:
    """Base temporal-expression node. Nodes are hashable by identity."""

    prec: int
    name: str

    @property
    def args(self) -> tuple["Node", ...]:
        return ()

    def _replace_args(self, new_args: Sequence["Node"]) -> "Node":
        assert not new_args
        return self


def _mk_name(prefix: str) -> str:
    return f"{prefix}_{next(_ids)}"


@dataclasses.dataclass(frozen=True, eq=False)
class Input(Node):
    """Source temporal object.  ``fields`` documents payload structure.

    ``keyed=True`` declares a *partitioned* stream (one independent
    sub-stream per key — user / stock symbol / campaign).  The time-centric
    semantics are per-key; ``parallel.batch_run`` runs the key axis as a
    leading axis of every tensor.
    """

    fields: tuple[str, ...] = ()
    keyed: bool = False

    @staticmethod
    def make(name: str, prec: int = 1, fields: tuple[str, ...] = (),
             keyed: bool = False) -> "Input":
        return Input(prec=prec, name=name, fields=fields, keyed=keyed)


@dataclasses.dataclass(frozen=True, eq=False)
class Const(Node):
    value: Any = 0.0

    @staticmethod
    def make(value: Any, prec: int = 1) -> "Const":
        return Const(prec=prec, name=_mk_name("const"), value=value)


@dataclasses.dataclass(frozen=True, eq=False)
class Map(Node):
    """Elementwise transformation at aligned time instants.

    ``fn`` maps the argument *values* (pytrees) to the output value.  It must
    be a pure function of torch tensors.  Validity is the AND of argument
    validities (strict-overlap Join semantics for arity ≥ 2).

    With ``phi_aware=True`` the function instead receives ``(value, valid)``
    pairs and returns a ``(value, valid)`` pair — this expresses φ-sensitive
    expressions like the paper's ``(~x[t] != φ) ? ~x[t] : ~avg[t]``
    (imputation / coalesce / left-join patterns).
    """

    fn: Callable[..., Any] = None
    phi_aware: bool = False
    _args: tuple[Node, ...] = ()

    @property
    def args(self) -> tuple[Node, ...]:
        return self._args

    def _replace_args(self, new_args):
        return dataclasses.replace(self, _args=tuple(new_args))

    @staticmethod
    def make(fn: Callable[..., Any], args: Sequence[Node],
             prec: Optional[int] = None, name: Optional[str] = None,
             phi_aware: bool = False) -> "Map":
        args = tuple(args)
        q = prec if prec is not None else max(a.prec for a in args)
        for a in args:
            if q % a.prec != 0 and a.prec % q != 0:
                raise ValueError(
                    f"precision mismatch: arg {a.name} prec={a.prec} vs out prec={q}")
        return Map(prec=q, name=name or _mk_name("map"), fn=fn,
                   phi_aware=phi_aware, _args=args)


@dataclasses.dataclass(frozen=True, eq=False)
class Where(Node):
    """``out[t] = pred(in[t]) ? in[t] : φ``."""

    pred: Callable[[Any], Any] = None
    _args: tuple[Node, ...] = ()

    @property
    def args(self) -> tuple[Node, ...]:
        return self._args

    def _replace_args(self, new_args):
        return dataclasses.replace(self, _args=tuple(new_args))

    @staticmethod
    def make(pred: Callable[[Any], Any], arg: Node,
             name: Optional[str] = None) -> "Where":
        return Where(prec=arg.prec, name=name or _mk_name("where"),
                     pred=pred, _args=(arg,))


@dataclasses.dataclass(frozen=True, eq=False)
class Shift(Node):
    """``out[t] = in[t - delta]`` (delta in time units, multiple of prec)."""

    delta: int = 0
    _args: tuple[Node, ...] = ()

    @property
    def args(self) -> tuple[Node, ...]:
        return self._args

    def _replace_args(self, new_args):
        return dataclasses.replace(self, _args=tuple(new_args))

    @staticmethod
    def make(arg: Node, delta: int, name: Optional[str] = None,
             prec: Optional[int] = None) -> "Shift":
        # delta need not be a multiple of the precision: the hold-alignment
        # rule (latest tick ≤ τ−delta) gives sub-precision shifts exact
        # snapshot semantics.  ``prec`` re-domains the result (e.g. shifting
        # a strided aggregate onto the fine grid to broadcast window stats
        # over the window's own ticks).
        return Shift(prec=prec or arg.prec, name=name or _mk_name("shift"),
                     delta=delta, _args=(arg,))


@dataclasses.dataclass(frozen=True, eq=False)
class Reduce(Node):
    """``out[t] = ⊕(op, ~in[t - window : t])`` on an output domain of
    precision ``prec`` (== stride).  ``window`` is in time units and must be
    a multiple of the input precision.

    ``op`` is a key into reduction.REDUCTIONS (sum/count/mean/max/min/...)
    or a custom :class:`reduction.Reduction`.
    """

    op: Any = "sum"
    window: int = 0
    field: Optional[str] = None  # reduce a single payload field of a dict stream
    _args: tuple[Node, ...] = ()

    @property
    def args(self) -> tuple[Node, ...]:
        return self._args

    def _replace_args(self, new_args):
        return dataclasses.replace(self, _args=tuple(new_args))

    @staticmethod
    def make(op: Any, arg: Node, window: int, stride: Optional[int] = None,
             field: Optional[str] = None, name: Optional[str] = None) -> "Reduce":
        stride = stride if stride is not None else arg.prec
        if window % arg.prec != 0:
            raise ValueError("window must be a multiple of input precision")
        if stride % arg.prec != 0:
            raise ValueError("stride must be a multiple of input precision")
        return Reduce(prec=stride, name=name or _mk_name(f"{op}w{window}"),
                      op=op, window=window, field=field, _args=(arg,))


@dataclasses.dataclass(frozen=True, eq=False)
class Interp(Node):
    """Gap reconstruction for signal imputation / resampling.

    mode='hold':   last valid value within max_gap ticks.
    mode='linear': linear interpolation between the nearest valid neighbours
                   within ±max_gap ticks (paper's resampling app [55]).
    Output precision may differ from input precision (resampling).
    """

    mode: str = "hold"
    max_gap: int = 0  # time units; bounds the lookback/lookahead
    _args: tuple[Node, ...] = ()

    @property
    def args(self) -> tuple[Node, ...]:
        return self._args

    def _replace_args(self, new_args):
        return dataclasses.replace(self, _args=tuple(new_args))

    @staticmethod
    def make(arg: Node, mode: str, max_gap: int, prec: Optional[int] = None,
             name: Optional[str] = None) -> "Interp":
        return Interp(prec=prec or arg.prec, name=name or _mk_name(f"interp_{mode}"),
                      mode=mode, max_gap=max_gap, _args=(arg,))


# ---------------------------------------------------------------------------
# DAG utilities
# ---------------------------------------------------------------------------

def topo_order(root: Node) -> list[Node]:
    """Post-order (deps first) topological order of the expression DAG."""
    return topo_order_multi([root])


def topo_order_multi(roots: Sequence[Node]) -> list[Node]:
    """Post-order over the *union* DAG of several roots (shared nodes once).

    Within each root's subtree, and across roots, every node appears after
    all of its arguments — the property the multi-query planner and the
    boundary-resolution reverse pass rely on.
    """
    seen: dict[int, Node] = {}
    order: list[Node] = []

    def visit(n: Node):
        if id(n) in seen:
            return
        seen[id(n)] = n
        for a in n.args:
            visit(a)
        order.append(n)

    for r in roots:
        visit(r)
    return order


def free_inputs(root: Node) -> list[Input]:
    return [n for n in topo_order(root) if isinstance(n, Input)]


def validate(root: Node) -> None:
    """Sanity-check precisions and windows along the DAG."""
    for n in topo_order(root):
        if isinstance(n, Reduce):
            (a,) = n.args
            assert n.window % a.prec == 0, n.name
            assert n.prec % a.prec == 0, (
                f"{n.name}: stride {n.prec} not a multiple of input prec {a.prec}")
        for a in n.args:
            assert (n.prec % a.prec == 0) or (a.prec % n.prec == 0), (
                f"{n.name}: unalignable precisions {n.prec} vs {a.prec}")


# ---------------------------------------------------------------------------
# canonical structural fingerprints (multi-query sharing)
# ---------------------------------------------------------------------------
#
# Two sub-DAGs may be evaluated once and shared between concurrent queries
# iff they are *structurally* identical: same node kinds, same static
# parameters, same user functions, same inputs.  ``fingerprint`` hashes
# exactly that — a hash-consing key over (op, params, argument fingerprints),
# with source nodes keyed by (name, prec, keyed), i.e. by their grid.
#
# The digest must be stable across processes (a plan cache keyed by it may
# outlive one interpreter), so the encoding never uses ``id()`` or Python's
# randomized ``hash()``: callables are tokenized by their bytecode, constants,
# names, defaults and closure *values* (not cells), and everything is folded
# through sha256.  Auto-generated node names (``map_17``) carry a global
# counter and are deliberately excluded — only ``Input`` names are identity.

def _value_token(v, seen=None) -> tuple:
    """Deterministic, process-stable token for a Python value."""
    if seen is None:
        seen = set()
    if v is None or isinstance(v, (bool, int, str, bytes)):
        return ("prim", type(v).__name__, repr(v))
    if isinstance(v, float):
        return ("float", repr(v))  # repr distinguishes -0.0, round-trips
    if isinstance(v, (tuple, list)):
        return ("seq", type(v).__name__,
                tuple(_value_token(x, seen) for x in v))
    if isinstance(v, dict):
        return ("dict", tuple(sorted(
            (_value_token(k, seen), _value_token(x, seen))
            for k, x in v.items())))
    if isinstance(v, types.ModuleType):
        return ("module", v.__name__)
    if isinstance(v, types.CodeType):
        return _code_token(v, seen)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return ("dataclass", type(v).__qualname__, tuple(
            (f.name, _value_token(getattr(v, f.name), seen))
            for f in dataclasses.fields(v)))
    # numpy scalars / small arrays (window params, thresholds)
    tobytes = getattr(v, "tobytes", None)
    dtype = getattr(v, "dtype", None)
    if tobytes is not None and dtype is not None:
        return ("ndarray", str(dtype), tuple(getattr(v, "shape", ())),
                v.tobytes())
    if callable(v):
        return _callable_token(v, seen)
    # generic parameter object: identity is its type + attribute state
    state = getattr(v, "__dict__", None)
    if state is not None:
        if id(v) in seen:
            return ("cycle",)
        seen.add(id(v))
        return ("obj", type(v).__qualname__, tuple(sorted(
            (k, _value_token(x, seen)) for k, x in state.items())))
    raise ValueError(
        f"cannot fingerprint value of type {type(v).__name__} ({v!r}); "
        "query closures must hold primitives, arrays or functions")


def _code_token(code: types.CodeType, seen) -> tuple:
    # co_filename / lineno / varnames excluded: renaming locals or moving a
    # lambda between files does not change what it computes.
    return ("code", code.co_code,
            tuple(_value_token(c, seen) for c in code.co_consts),
            code.co_names, code.co_argcount, code.co_kwonlyargcount,
            code.co_flags & 0x0c)  # *args / **kwargs flags only


def _referenced_names(code: types.CodeType) -> set:
    """Global names a code object (or its nested lambdas) actually loads.

    Only LOAD_GLOBAL/LOAD_NAME targets count — ``co_names`` also holds
    attribute/method names (``v.mean()``), which must not be resolved
    against the defining module's namespace.
    """
    names = {ins.argval for ins in dis.get_instructions(code)
             if ins.opname in ("LOAD_GLOBAL", "LOAD_NAME")}
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _referenced_names(c)
    return names


def _callable_token(fn, seen=None) -> tuple:
    if seen is None:
        seen = set()
    if id(fn) in seen:
        # back-edge (mutually recursive helpers) or re-reference: traversal
        # order is deterministic, so the marker is too
        return ("cycle",)
    seen.add(id(fn))
    # bound method: the receiver's state is part of what it computes
    # (Thresh(1.0).pred vs Thresh(5.0).pred share bytecode, not behaviour)
    self_obj = getattr(fn, "__self__", None)
    func = getattr(fn, "__func__", None)
    if self_obj is not None and func is not None:
        return ("bound", _callable_token(func, seen),
                _value_token(self_obj, seen))
    if isinstance(fn, functools.partial):
        return ("partial", _callable_token(fn.func, seen),
                tuple(_value_token(a, seen) for a in fn.args),
                tuple(sorted((k, _value_token(v, seen))
                             for k, v in fn.keywords.items())))
    code = getattr(fn, "__code__", None)
    if code is not None:
        defaults = tuple(_value_token(d, seen)
                         for d in (fn.__defaults__ or ()))
        kwdefaults = tuple(sorted(
            (k, _value_token(v, seen))
            for k, v in (fn.__kwdefaults__ or {}).items()))
        cells = fn.__closure__ or ()
        closure = tuple(_value_token(c.cell_contents, seen) for c in cells)
        # captured globals: a lambda reading module-level state by name
        # computes different things in different namespaces even with equal
        # bytecode, so the referenced values are part of the structure
        glob = getattr(fn, "__globals__", None) or {}
        gtoks = tuple((nm, _value_token(glob[nm], seen))
                      for nm in sorted(_referenced_names(code))
                      if nm in glob)
        return ("fn", _code_token(code, seen), defaults, kwdefaults,
                closure, gtoks)
    # builtins / ufuncs / C functions: identified by qualified name
    name = getattr(fn, "__qualname__", None) or getattr(fn, "__name__", None)
    if name is not None:
        return ("named_callable", getattr(fn, "__module__", None), name)
    call = getattr(type(fn), "__call__", None)
    if call is not None and getattr(call, "__code__", None) is not None:
        state = getattr(fn, "__dict__", {})
        return ("obj_call", type(fn).__qualname__, _callable_token(call, seen),
                tuple(sorted((k, _value_token(v, seen))
                             for k, v in state.items())))
    raise ValueError(f"cannot fingerprint callable {fn!r}")


def _node_token(n: Node, arg_fps: tuple) -> tuple:
    if isinstance(n, Input):
        return ("input", n.name, n.prec, n.keyed, n.fields)
    if isinstance(n, Const):
        return ("const", _value_token(n.value), n.prec)
    if isinstance(n, Map):
        return ("map", _callable_token(n.fn), n.prec, n.phi_aware, arg_fps)
    if isinstance(n, Where):
        return ("where", _callable_token(n.pred), n.prec, arg_fps)
    if isinstance(n, Shift):
        return ("shift", n.delta, n.prec, arg_fps)
    if isinstance(n, Reduce):
        op = n.op if isinstance(n.op, str) else _value_token(n.op)
        return ("reduce", op, n.window, n.prec, n.field, arg_fps)
    if isinstance(n, Interp):
        return ("interp", n.mode, n.max_gap, n.prec, arg_fps)
    raise TypeError(type(n))  # pragma: no cover


def fingerprint(root: Node) -> str:
    """Canonical structural fingerprint (sha256 hex) of a node's sub-DAG.

    ``fingerprint(a) == fingerprint(b)`` iff ``a`` and ``b`` are
    structurally equal: same DAG shape, node kinds, static parameters and
    user functions (compared by bytecode + captured values).  Stable across
    processes and hash seeds; cached on the node.
    """
    memo: dict[int, str] = {}

    def fp(n: Node) -> str:
        cached = n.__dict__.get("_fingerprint")
        if cached is not None:
            return cached
        if id(n) in memo:
            return memo[id(n)]
        token = _node_token(n, tuple(fp(a) for a in n.args))
        digest = hashlib.sha256(repr(token).encode()).hexdigest()
        memo[id(n)] = digest
        object.__setattr__(n, "_fingerprint", digest)
        return digest

    return fp(root)
