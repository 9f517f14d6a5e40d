"""Shared-plan cache: structural interning + union-DAG sharing analysis
(port of ``repro.multiquery.shared``).

The multi-query layer's CSE happens here, *across* queries: every node of
every registered query is interned by its canonical structural fingerprint
(:func:`repro_torch.core.ir.fingerprint`), so two dashboards that each build
``source.window(50).mean()`` from scratch end up holding the *same* IR node
object.  The union DAG of N query roots then partitions into

* **shared interior nodes** — reachable from ≥ 2 query roots; evaluated
  exactly once per chunk and fanned out to every consumer, and
* **per-query heads** — nodes private to one query (final thresholds,
  projections); evaluated per query.

The cache also memoizes per-``(fingerprint, span)`` planning artifacts so
attaching a query whose sub-plans are already resident costs no planning
work for the shared prefix.

With ``persist=<path>`` the artifact store round-trips to disk (one
pickle, atomic writes): plan artifacts are keyed by ``(structural
fingerprint, out_len)`` — pure-data planning products only
(:class:`~repro_torch.core.plan.InputSpec` halo contracts,
:class:`~repro_torch.core.plan.ChangePlan`, output geometry, φ seed
shapes), never live IR or closures — so a *fresh process* serving an
already-planned query skips planning entirely.  This is the cross-session
plan sharing a serving warm start builds on (ROADMAP A13 ports the
serving layer).  The store has its own schema, and loading it resolves
only classes of this package, numpy's and Python's own: a store that
names anything else (the reference package's, say) is treated as torn.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Dict, List, Optional, Sequence, Set

from ..core import ir

__all__ = ["SharedPlanCache", "SharingReport", "load_plain"]

_PLAN_SCHEMA = "repro_torch.plans/v1"
_SAFE_MODULES = ("repro_torch.", "numpy.", "builtins.", "collections.",
                 "copyreg.", "_codecs.")


class _Unpickler(pickle.Unpickler):
    """Resolves only the classes a plan store may hold."""

    def find_class(self, module, name):
        if not (module + ".").startswith(_SAFE_MODULES):
            raise pickle.UnpicklingError(f"plan store names {module}.{name}")
        return super().find_class(module, name)


def load_plain(f):
    """Unpickle a store of plain data from the open file ``f``: only
    classes of this package, numpy's and Python's own resolve (the plan
    store here, the capture manifests of :mod:`repro_torch.serve.aot`)."""
    return _Unpickler(f).load()


@dataclasses.dataclass(frozen=True)
class SharingReport:
    """How much work the union DAG saves over independent execution."""

    n_queries: int
    union_nodes: int          # nodes evaluated once per chunk, total
    independent_nodes: int    # sum of per-query DAG sizes (no sharing)
    shared_nodes: int         # union nodes reachable from >= 2 queries
    head_nodes: Dict[str, int]  # per query: nodes private to it

    @property
    def sharing_ratio(self) -> float:
        """independent / union node evaluations (1.0 = nothing shared)."""
        return self.independent_nodes / max(self.union_nodes, 1)


class SharedPlanCache:
    """Interns query IR by structural fingerprint (cross-query hash-consing).

    ``intern`` rebuilds a query bottom-up, replacing every sub-DAG whose
    fingerprint is already resident with the cached canonical node — after
    which structural identity *is* object identity, and the union DAG of any
    set of interned roots shares sub-plans maximally.  A cache instance may
    serve many sessions; it only ever grows.
    """

    def __init__(self, persist: Optional[str] = None):
        self._canon: Dict[str, ir.Node] = {}   # fingerprint -> canonical node
        # (fingerprint, out_len) -> pure-data plan artifact (module
        # docstring); round-trips to ``persist`` when given
        self._plans: Dict[tuple, dict] = {}
        self._persist = persist
        if persist and os.path.exists(persist):
            try:
                with open(persist, "rb") as f:
                    doc = load_plain(f)
                if isinstance(doc, dict) and doc.get("schema") == _PLAN_SCHEMA:
                    self._plans = dict(doc["plans"])
            except Exception:
                # a torn/stale store degrades to planning, never an error
                self._plans = {}

    def __len__(self) -> int:
        return len(self._canon)

    # -- persisted plan artifacts --------------------------------------------
    def plan_artifact(self, fp: str, out_len: int) -> Optional[dict]:
        """The memoized (possibly persisted) plan artifact for one
        ``(structural fingerprint, out_len)`` point, or ``None``."""
        return self._plans.get((fp, int(out_len)))

    def store_artifact(self, fp: str, out_len: int, artifact: dict) -> None:
        """Memoize a plan artifact and (when persisting) write through."""
        self._plans[(fp, int(out_len))] = artifact
        self.save()

    def save(self) -> None:
        """Atomically write the artifact store to the ``persist`` path
        (no-op for in-memory caches)."""
        if not self._persist:
            return
        d = os.path.dirname(os.path.abspath(self._persist))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump({"schema": _PLAN_SCHEMA, "plans": self._plans}, f)
            os.replace(tmp, self._persist)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def intern(self, root: ir.Node) -> ir.Node:
        """Canonical (interned) equivalent of ``root``; subsumes per-query
        CSE and deduplicates against every previously interned query."""
        out: Dict[int, ir.Node] = {}
        for n in ir.topo_order(root):
            args = tuple(out[id(a)] for a in n.args)
            m = n._replace_args(args) if n.args else n
            fp = ir.fingerprint(m)
            if fp not in self._canon:
                self._canon[fp] = m
            out[id(n)] = self._canon[fp]
        return out[id(root)]

    def node_for(self, fp: str) -> ir.Node:
        return self._canon[fp]

    # -- union-DAG analysis --------------------------------------------------
    @staticmethod
    def reachable(root: ir.Node) -> Set[int]:
        return {id(n) for n in ir.topo_order(root)}

    @classmethod
    def partition(cls, roots: Dict[str, ir.Node]
                  ) -> tuple[List[ir.Node], Dict[str, List[ir.Node]]]:
        """Split the union DAG into (shared interior nodes, per-query heads).

        ``roots`` maps query name -> interned root.  A node is *shared* when
        it is reachable from at least two roots; every other node belongs to
        exactly one query's head.  Returns nodes in union topo order.
        """
        reach = {q: cls.reachable(r) for q, r in roots.items()}
        order = ir.topo_order_multi(list(roots.values()))
        shared: List[ir.Node] = []
        heads: Dict[str, List[ir.Node]] = {q: [] for q in roots}
        for n in order:
            owners = [q for q, ids in reach.items() if id(n) in ids]
            if len(owners) >= 2:
                shared.append(n)
            else:
                heads[owners[0]].append(n)
        return shared, heads

    @classmethod
    def report(cls, roots: Dict[str, ir.Node]) -> SharingReport:
        shared, heads = cls.partition(roots)
        union = len(ir.topo_order_multi(list(roots.values())))
        indep = sum(len(ir.topo_order(r)) for r in roots.values())
        return SharingReport(
            n_queries=len(roots), union_nodes=union,
            independent_nodes=indep, shared_nodes=len(shared),
            head_nodes={q: len(h) for q, h in heads.items()})
