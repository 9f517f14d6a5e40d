"""Multi-query sharing: serve N concurrent queries from one stream pass
(port of ``repro.multiquery``).

TiLT's planner (plan.py) makes a query's grids, alignments and halos a
*static artifact*; this package exploits the consequence the per-query
layers cannot: two sub-DAGs from *different* queries are interchangeable
iff their structural fingerprints match — same ops, same static parameters,
same sources-by-grid (ir.fingerprint).  The serving scenario (thousands of
dashboards watching the same sources) then reduces to classic shared-
operator execution, resolved entirely at plan time.  The subsystem owns, in
exactly one place:

* :class:`~repro_torch.multiquery.shared.SharedPlanCache` — cross-query CSE by
  hash-consing: interned queries share IR node objects for structurally
  equal sub-plans, and the union DAG of N roots partitions into *shared
  interior nodes* (reachable from ≥ 2 queries; evaluated once per chunk)
  and *per-query heads* (final thresholds / projections).
* :func:`repro_torch.core.plan.plan_union` — one static plan for the union DAG:
  every node's grid covers the union of all consumers' demands, and the
  per-source halo contracts merge across queries into a single partition
  contract.
* :class:`~repro_torch.multiquery.session.MultiQuerySession` — the
  serving layer: registered queries advance through the policy runner
  (``repro_torch.engine.Runner`` with ``ExecPolicy(dag="union")``) — one
  union evaluation per chunk runs every node of the union DAG once through
  the same node evaluator the per-query executors use
  (``compile.eval_op``), the runner's state pytree under the merged halo
  contract is the only cross-chunk state, attach/detach between chunks
  re-fits it deterministically, and the policy axes compose: keyed (K
  sub-streams × N queries) and sparse (``sparse=True`` — the merged
  ChangePlan of the union DAG lets clean segments and keys skip the whole
  union evaluation).  :func:`~repro_torch.multiquery.session.union_runner`
  exposes the same composition without the attach/detach machinery.
* :func:`~repro_torch.multiquery.session.shard_union_run` — the union DAG
  with the *timeline* sharded over a device mesh: the merged per-source
  halo contracts are assembled by the multi-hop chain (core/halo.py), so
  union plans whose windows exceed the per-shard span shard fine; and
  ``MultiQuerySession(mesh=...)`` shards a keyed session's key axis.

Sharing model in one line: *fingerprint-equal ⇒ plan-equal ⇒ evaluate
once* — correctness rests on fingerprints implying structural equality
(property-tested), and on the union plan widening grids only conservatively
(extra φ-padded halo ticks are semantically invisible).  Numerically,
widening is exact for φ-masking, alignment and associative-exact reductions
(max/min, integer-valued sums); for inexact float reductions the blocked
sliding-sum may associate differently on a union-widened grid than on the
query's solo grid, so shared-vs-independent agreement is bitwise for
exactly-representable data and within the kernel's documented
window-bounded error otherwise (see kernels/ops.py).
"""
from .session import (MultiQuerySession, shard_union_run, union_body_spec,
                      union_runner)
from .shared import SharedPlanCache, SharingReport

__all__ = ["MultiQuerySession", "SharedPlanCache", "SharingReport",
           "shard_union_run", "union_body_spec", "union_runner"]
