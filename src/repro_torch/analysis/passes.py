"""The static hot-path passes: transfer-freedom, state-in-place
(donation), collective placement, recompile hazards, revision-horizon
coverage and serving readiness; port of ``repro.analysis.passes``.

Each pass takes an :class:`AuditTarget`, a runner plus its audit surface
(the steps one chunk runs and the whole-chunk function
``engine/runner.py`` exposes), and returns
:class:`repro_torch.analysis.findings.Finding` records under the
reference's codes wherever the meaning carries over.  The reference proves
its invariants from traced jaxprs; the port proves them from the recorded
step program (:mod:`repro_torch.analysis.graphs`):

* **transfer**: the whole-chunk program runs its work inside one ``step``
  frame (one captured graph on the card) plus views; any other operation
  outside it is eager per-chunk work, and an operation that waits for the
  device to read a value on the host (``.item()``, ``nonzero``,
  ``equal``, a copy to the CPU) is a synchronizing call wherever it sits
  (the CPU's ``bucket-pick`` excepted, where the CPU path reads the count
  by design).  On a CUDA target a twin of the runner also steps a steady
  chunk under ``torch.cuda.set_sync_debug_mode("error")`` and counts the
  graphs it replays.
* **donation**: the reference's donated state is the port's state written
  in place.  Every state buffer of the step's workspace (tails, dirty
  tails, snapshots, hold seeds, metric accumulators; by storage) must be
  read by the step, and written in place: one it never reads is dead
  state, one it reads but never writes is not recycled in place.
* **collective**: c10d operations inside a ``body[cap]`` frame.  Ranks
  compact apart, so they can pick different bodies, and the ones in the
  collective wait forever on the ones that are not.
* **recompile**: the step cache's key must move whenever the workspace a
  step is built and captured for would.  Runtime rebuilds from the tracer
  join the same report.
"""
from __future__ import annotations

import dataclasses
import gc
import numbers
from typing import Dict, List, Optional

import torch

from ..engine import capture
from .findings import Finding
from .graphs import STEP, record, storage_key

__all__ = ["AuditTarget", "make_target", "pass_transfers", "pass_donation",
           "pass_collectives", "pass_recompile", "pass_revision",
           "pass_serving"]

# eager operations that copy, with the reference's name for their class
_COPIES = frozenset({"clone", "cat", "copy_", "_to_copy", "stack",
                     "index", "index_select"})


@dataclasses.dataclass
class AuditTarget:
    """One policy-lattice point under audit: the runner, the steps one
    chunk runs (``runner.staged_steps``, built at first use when ``None``)
    and the chunk variants to record, on ``device`` (default: the
    runner's, :meth:`repro_torch.engine.Runner.audit_example_chunks`).
    Recordings are made once and shared by the passes."""

    runner: object
    policy: str
    steps: Optional[List[Dict]] = None
    chunk_variants: tuple = ()
    device: Optional[torch.device] = None
    _chunks: Optional[Dict] = None
    _step_records: Dict = dataclasses.field(default_factory=dict)
    _chunk_records: Dict = dataclasses.field(default_factory=dict)

    def chunks(self) -> Dict:
        """The example chunks every recording runs over."""
        if self._chunks is None:
            self._chunks = self.runner.audit_example_chunks(self.device)
        return self._chunks

    @property
    def dev(self) -> torch.device:
        return next(iter(self.chunks().values())).valid.device

    def staged(self) -> List[Dict]:
        if self.steps is None:
            self.steps = self.runner.staged_steps(self.chunks())
        return self.steps

    def step_record(self, step: Dict):
        """``(buffers, sites)``: the step's workspace state buffers by
        path (their storages, taken before it runs) and its recorded
        program."""
        label = step["label"]
        if label not in self._step_records:
            work = step["args"][0]
            bufs = {p: storage_key(x)
                    for p, x in work.state_buffers().items()}
            self._step_records[label] = (bufs,
                                         record(step["fn"], *step["args"])[1])
        return self._step_records[label]

    def chunk_sites(self, variant: str):
        """The recorded program of one whole-chunk variant."""
        if variant not in self._chunk_records:
            fn, args = self.runner.chunk_fn(variant, chunks=self.chunks())
            self._chunk_records[variant] = record(fn, *args)[1]
        return self._chunk_records[variant]


def make_target(runner, policy: Optional[str] = None,
                device=None) -> AuditTarget:
    """The audit surface of one runner (any policy point) on ``device``
    (default: the runner's)."""
    variants = (("steady", "first") if runner.policy.sparse else ("dense",))
    return AuditTarget(
        runner=runner,
        policy=policy if policy is not None else runner.policy.describe(),
        chunk_variants=variants,
        device=None if device is None else torch.device(device))


def _sibling(runner, *, n_keys=None, segs=None):
    """A runner of the same class over the same body (and step cache) and
    policy, its own workspace and metrics: ``n_keys``/``segs`` perturb one
    configuration degree of freedom, and a revision ring is mirrored."""
    sib = type(runner)(
        runner.spec, runner.policy,
        n_keys=(n_keys if n_keys is not None
                else (runner.n_keys if runner.policy.keyed else None)),
        segs_per_chunk=segs if segs is not None else runner.n_segs)
    if runner._rev_ring is not None:
        sib.enable_revision(runner.revision_horizon, runner.revise_bound)
    return sib


# ---------------------------------------------------------------------------
# transfer-freedom
# ---------------------------------------------------------------------------

def _live_replay(target: AuditTarget) -> List[Finding]:
    """A twin of the runner (its own workspace, so the audited stream is
    untouched) steps two chunks, which captures its graphs, then one
    steady chunk under the sync debug mode set to raise: a synchronizing
    call is an error; more or fewer graphs than one a warning."""
    out = []
    twin = _sibling(target.runner)
    chunks = target.chunks()
    try:
        twin.step(chunks)
        twin.step(chunks)
        torch.cuda.synchronize(target.dev)
        n0 = capture.replays["graph"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            twin.step(chunks)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            out.append(Finding(
                "error", "transfer", "host-sync",
                "a steady chunk made a synchronizing call on the card "
                f"({str(e).splitlines()[0]})", policy=target.policy,
                target="steady (replayed)"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        graphs = capture.replays["graph"] - n0
    finally:
        del twin
        gc.collect()
    if not out and graphs != 1:
        out.append(Finding(
            "warning", "transfer", "staged-dispatch-count",
            f"a steady chunk replays {graphs} captured graphs (expected "
            "exactly 1 per chunk)", policy=target.policy,
            target="steady (replayed)", provenance=f"graphs={graphs}"))
    return out


def pass_transfers(target: AuditTarget) -> List[Finding]:
    """Flag anything on the chunk path that runs outside the one staged
    step, or waits for the device, in the steady state (see the module
    docstring).  In torch ``x[0]`` is a view, so the reference's eager
    indexing class (slices binding host scalars) has no counterpart
    here."""
    out = []
    cpu = target.dev.type == "cpu"
    for variant in target.chunk_variants:
        steps = set()
        for site in target.chunk_sites(variant):
            step = site.frame(STEP)
            if step is not None:
                steps.add(step)
            if site.syncs and not (cpu and site.frame("bucket-pick")):
                out.append(Finding(
                    "error", "transfer", "host-sync",
                    f"chunk variant {variant!r} runs {site.op!r}, which "
                    "waits for the device and reads a value on the host: a "
                    "synchronizing call on every chunk (the C1 class)",
                    policy=target.policy, target=variant,
                    provenance=site.provenance()))
            if step is None and not site.metadata:
                hint = (" — the C3 class: a copy per chunk outside the "
                        "step (write into the workspace inside it)"
                        if site.name in _COPIES else "")
                out.append(Finding(
                    "error", "transfer", "eager-op-outside-staged-step",
                    f"chunk variant {variant!r} runs eager op {site.op!r} "
                    f"outside the staged step{hint}",
                    policy=target.policy, target=variant,
                    provenance=site.provenance()))
        if len(steps) != 1:
            out.append(Finding(
                "warning", "transfer", "staged-dispatch-count",
                f"chunk variant {variant!r} runs {len(steps)} staged steps "
                "(graphs on the card; expected exactly 1 per chunk)",
                policy=target.policy, target=variant,
                provenance=f"steps={len(steps)}"))
    if not cpu:
        out += _live_replay(target)
    return out


# ---------------------------------------------------------------------------
# donation: state written in place
# ---------------------------------------------------------------------------

def _state_use(target: AuditTarget, step: Dict) -> Dict[str, str]:
    """Per state buffer of the step's workspace that is not recycled in
    place: ``"dead"`` (never read) or ``"unaliased"`` (read, never
    written)."""
    bufs, sites = target.step_record(step)
    reads = set().union(*(s.reads for s in sites))
    writes = set().union(*(s.writes for s in sites))
    return {p: ("dead" if k not in reads else "unaliased")
            for p, k in bufs.items()
            if k not in reads or k not in writes}


def pass_donation(target: AuditTarget) -> List[Finding]:
    """Per state buffer of every step's workspace: read and written in
    place?  One the step never reads is dead state riding the workspace
    (the reference's dead ``prev`` snapshot class); one it reads but never
    writes is not recycled in place, so the next chunk's state must come
    from a copy or a fresh tensor (a warning, as the reference's
    unaliased donated leaf)."""
    out = []
    for step in target.staged():
        for path, use in _state_use(target, step).items():
            if use == "dead":
                out.append(Finding(
                    "error", "donation", "donated-leaf-dead",
                    f"step {step['label']!r} carries state buffer {path} "
                    "but never reads it — dead state riding the workspace "
                    "(the dead prev-snapshot class)",
                    policy=target.policy, target=step["label"],
                    provenance=path))
            else:
                out.append(Finding(
                    "warning", "donation", "donated-leaf-unaliased",
                    f"step {step['label']!r} reads state buffer {path} but "
                    "never writes it in place — the next chunk's state is "
                    "made elsewhere instead of recycling the buffer",
                    policy=target.policy, target=step["label"],
                    provenance=path))
    return out


# ---------------------------------------------------------------------------
# collective placement
# ---------------------------------------------------------------------------

def pass_collectives(target: AuditTarget) -> List[Finding]:
    """Collectives inside a compacted body (``body[cap]`` frames): ranks
    that pick different buckets run different bodies, and a collective
    only some of them reach hangs."""
    out = []
    for step in target.staged():
        for site in target.step_record(step)[1]:
            if not site.collective:
                continue
            frames = site.divergent_frames()
            if frames:
                out.append(Finding(
                    "error", "collective", "collective-under-divergence",
                    f"step {step['label']!r} runs collective {site.op!r} "
                    f"under divergent control "
                    f"({'/'.join(f.name for f in frames)}) — ranks picking "
                    "different buckets deadlock",
                    policy=target.policy, target=step["label"],
                    provenance=site.provenance()))
    return out


# ---------------------------------------------------------------------------
# recompile hazards
# ---------------------------------------------------------------------------

def _probe_signature(runner, device) -> tuple:
    """What the steps are built and captured for: the workspace layout of
    the example chunks and the state buffers' shapes and dtypes, from a
    fresh workspace (no step built, nothing captured, no cache touched)."""
    chunk_in = runner._ingest(runner.audit_example_chunks(device))
    work = runner._audit_state(chunk_in, runner._chunk_device(chunk_in))
    bufs = tuple(sorted((p, tuple(x.shape), str(x.dtype))
                        for p, x in work.state_buffers().items()))
    return (work.layout, bufs,
            ("__static", runner.policy.n_shards, runner.policy.axis))


def pass_recompile(target: AuditTarget) -> List[Finding]:
    """Three detectors in one report: the tracer's runtime rebuilds, host
    scalars among the steps' arguments (a capture bakes them in, so a
    later value is ignored), and the static probe of the step cache's key
    over the degrees of freedom ``segs_per_chunk`` and ``n_keys``.  Torch
    has no weak types, so the reference's ``weak-type-step-arg`` has no
    counterpart."""
    out = []
    r = target.runner
    for d in r.metrics.tracer.retrace_findings():
        out.append(Finding(
            d["severity"], "recompile", d["code"], d["message"],
            policy=target.policy, provenance=str(d["provenance"])))
    for step in target.staged():
        for i, arg in enumerate(step["args"]):
            if isinstance(arg, numbers.Number):
                out.append(Finding(
                    "error", "recompile", "host-scalar-step-arg",
                    f"step {step['label']!r} arg [{i}] is a host "
                    f"{type(arg).__name__}: a captured graph keeps the "
                    "value it was captured with",
                    policy=target.policy, target=step["label"],
                    provenance=f"[{i}]"))
    dev = target.dev
    sig0 = _probe_signature(r, dev)
    key0 = r._cache_key("probe", dev)
    probes = [("segs_per_chunk", dict(segs=r.n_segs * 2))]
    if r.policy.keyed:
        probes.append(("n_keys", dict(n_keys=r.n_keys * 2)))
    for dof, kw in probes:
        try:
            sib = _sibling(r, **kw)
        except (ValueError, NotImplementedError):
            continue  # geometry constraint forbids this perturbation
        if (_probe_signature(sib, dev) != sig0
                and sib._cache_key("probe", dev) == key0):
            out.append(Finding(
                "error", "recompile", "staging-key-under-captures",
                f"perturbing {dof} changes the workspace the steps are "
                "built and captured for but not the step cache's key — two "
                "geometries share one cache slot, so the second reuses "
                "steps built for the wrong shapes",
                policy=target.policy, target=dof,
                provenance=f"key={key0!r}"))
    return out


# ---------------------------------------------------------------------------
# revision-horizon coverage
# ---------------------------------------------------------------------------

def pass_revision(target: AuditTarget) -> List[Finding]:
    """Revision-enabled runners only: does the snapshot ring reach far
    enough back to revise every late event the declared lateness bound
    admits?  The required depth is pure ChangePlan arithmetic
    (:meth:`repro_torch.core.plan.ChangePlan.revision_horizon_chunks`): a
    patched tick up to ``revise_bound`` behind the sealed frontier
    dirties outputs reaching ``lookahead + prec`` further back, so an
    undersized ring silently refuses (drops) in-bound late events —
    a liveness bug no runtime test hits until real disorder does."""
    out = []
    r = target.runner
    if getattr(r, "_rev_ring", None) is None:
        return out  # revision disabled: nothing to cover
    bound = r.revise_bound
    if bound is None:
        out.append(Finding(
            "info", "revision", "revision-bound-undeclared",
            "revision ring enabled without a declared lateness bound "
            "(enable_revision(revise_bound=...)) — horizon coverage "
            "cannot be checked statically",
            policy=target.policy))
        return out
    cp = r.spec.change_plan
    if cp is None:
        out.append(Finding(
            "warning", "revision", "revision-horizon-unverifiable",
            "revision ring enabled on a body without a ChangePlan: the "
            "required horizon depth cannot be derived — late-event "
            "coverage rests on the caller's sizing alone",
            policy=target.policy))
        return out
    chunk_span = r.n_segs * r.spec.span
    need = cp.revision_horizon_chunks(bound, chunk_span)
    if r.revision_horizon < need:
        out.append(Finding(
            "error", "revision", "revision-horizon-undersized",
            f"revision ring holds {r.revision_horizon} chunk snapshots "
            f"but a lateness bound of {bound} time units over "
            f"{chunk_span}-unit chunks needs {need} "
            "(ChangePlan.revision_horizon_chunks): in-bound late events "
            "will be refused as beyond-horizon",
            policy=target.policy,
            provenance=f"have={r.revision_horizon} need={need}"))
    else:
        out.append(Finding(
            "info", "revision", "revision-horizon-covered",
            f"revision ring depth {r.revision_horizon} covers the "
            f"declared lateness bound {bound} (need {need})",
            policy=target.policy))
    return out


# ---------------------------------------------------------------------------
# serving readiness
# ---------------------------------------------------------------------------

_STEADY = ("sparse_fused(steady)", "dense")


def pass_serving(target: AuditTarget) -> List[Finding]:
    """Served runners only (``repro_torch.serve`` prepares every step
    ahead, ``Runner.install_executable``, which the tracer records as
    ``aot_installs``): every step the policy point runs must be prepared
    — on the card captured, its graph in the runner's workspace, so a
    served request never warms up or captures; on the CPU built to run
    eagerly, which is all a CPU service has — and the steady step must
    write its state in place (the donation pass's record over it), or
    every chunk makes its carried state anew.  Runners never prepared
    ahead (the lattice audit) have nothing to prove here."""
    out: List[Finding] = []
    r = target.runner
    installs = r.metrics.tracer.aot_installs()
    if not installs:
        return out  # not a served runner
    want = "eager" if target.dev.type == "cpu" else "captured"
    graphs = {}
    for work in (r._work, r._rwork):
        if work is not None:
            graphs.update(work.graphs)
    keys = r.aot_keys()
    for label, key in keys:
        how = installs.get(label)
        if how != want or (want == "captured" and key not in graphs):
            out.append(Finding(
                "error", "serving", "serving-step-not-aot",
                f"step {label} reachable by this served policy point was "
                f"not prepared ahead ({how or 'never'}; want {want}) — the "
                "first request would warm it up and capture it in-band",
                policy=target.policy, target=label))
            continue
        if label in _STEADY:
            step = next(s for s in target.staged() if s["label"] == label)
            missing = _state_use(target, step)
            if missing:
                out.append(Finding(
                    "error", "serving", "serving-donation-missing",
                    f"steady-state step {label} does not write its state "
                    "in place — every chunk makes the carried state anew "
                    "instead of recycling it",
                    policy=target.policy, target=label,
                    provenance=",".join(f"{p}:{u}" for p, u in
                                        sorted(missing.items()))))
    if not any(f.severity == "error" for f in out):
        out.append(Finding(
            "info", "serving", "serving-aot-complete",
            f"{len(keys)} steps prepared ahead ({want})",
            policy=target.policy))
    return out
