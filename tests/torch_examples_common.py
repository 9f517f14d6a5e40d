"""What the port's examples (``examples_torch/``) are held to, shared by
``tests/test_torch_examples.py`` (each example against the reference's on
the CPU) and ``chip_smoke.py`` (the card against the CPU).  Imports
neither jax nor the reference, so the card's script can use it.

``figures(name, result)`` splits an example's ``main`` result into the
figures held exactly (structure and integer counts) and the output grids
held by ``repro_torch.data.tolerance.compare`` under an app's entry;
``hold`` compares two such splits.  ``SIZES`` are the reduced sizes both
run at (module constants and ``main`` arguments); ``sized`` applies them.
"""
from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import torch

from repro_torch.data import tolerance

ROOT = Path(__file__).resolve().parents[1]

TILT = ("quickstart", "stream_analytics", "multikey_analytics", "late_data",
        "metrics_observability", "plan_audit", "serving_loop")
LM = ("serve_lm", "train_lm")

# name -> (module constants, main's arguments before --device); every
# CHUNK of stream_analytics is a multiple of each app's prec (1, 4, 10, 100)
SIZES = {
    "quickstart": ({}, []),
    "stream_analytics": ({"CHUNK": 2000}, ["2"]),
    "multikey_analytics": ({"N_TICKS": 10_000, "N_PARTS": 5}, ["8"]),
    "late_data": ({"N_CHUNKS": 4, "N": 4 * 256}, []),
    "metrics_observability": ({}, ["4"]),
    "plan_audit": ({}, []),
    "serving_loop": ({"N_CHUNKS": 4}, []),
}


def load(name: str, kind: str = "examples_torch"):
    """A fresh module object of ``<kind>/<name>.py`` (``examples_torch``,
    or the reference's ``examples``), under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        f"_{kind}_{name}", ROOT / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def sized(mod, consts: dict):
    """Set a module's constants for the block, then put them back."""
    old = {k: getattr(mod, k) for k in consts}
    for k, v in consts.items():
        setattr(mod, k, v)
    try:
        yield mod
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def leaves(value) -> dict:
    """A grid's value as ``{leaf: numpy}`` (``v`` for a plain tensor)."""
    if isinstance(value, dict):
        return {k: host(v) for k, v in value.items()}
    return {"v": host(value)}


def grids(parts) -> tuple:
    """Grids stitched along time: ``(valid, {leaf: value})`` as numpy."""
    parts = list(parts)
    valid = np.concatenate([host(g.valid) for g in parts], axis=-1)
    ls = [leaves(g.value) for g in parts]
    return valid, {k: np.concatenate([x[k] for x in ls], axis=-1)
                   for k in ls[0]}


def is_vol_head(name: str) -> bool:
    """The dashboard's breakout and momentum heads (``q{i}``, i % 4 in
    (2, 3)) read a stddev no tolerance holds across two builds
    (``repro_torch.data.tolerance``)."""
    return int(name[1:]) % 4 >= 2


def trend_head(q: str, grid) -> tuple:
    """A dashboard trend head's ``(valid, leaves)`` centred on its own
    threshold (``q{i}`` fires where the difference of means passes
    ``0.05 * (i // 4)``, up for i % 4 == 0, down for 1), so the tolerance's
    gate excuses a flip at that threshold, not at 0."""
    i = int(q[1:])
    edge = 0.05 * (i // 4) * (1 if i % 4 == 0 else -1)
    valid, ls = grids([grid])
    return valid, {k: v - np.float32(edge) for k, v in ls.items()}


def findings_key(findings) -> list:
    """Audit findings as comparable tuples: the message names the
    segments."""
    return [(f.severity, f.pass_name, f.code, f.message) for f in findings]


def figures(name: str, r: dict) -> tuple:
    """``(exact, outputs)`` of one port example's ``main`` result:
    ``exact`` figures compared with ``==``, ``outputs`` as
    ``{label: (tolerance entry or None for bit for bit, (valid, leaves))}``.
    """
    if name == "quickstart":
        exact = {"contract": {k: (b.lookback, b.lookahead)
                              for k, b in r["contract"].items()},
                 "fusion": r["fusion"]}
        return exact, {"uptrend": ("trend", grids([r["out"]]))}
    if name == "stream_analytics":
        exact, outs = {}, {}
        for app, a in r.items():
            exact[app] = (a["mode"], a.get("tails"))
            outs[app] = (app, grids(a["outputs"]))
        return exact, outs
    if name == "multikey_analytics":
        d = r["dashboard"]
        exact = {k: d[k] for k in ("union_nodes", "shared_nodes",
                                   "independent_nodes", "sharing_ratio")}
        outs = {"fraud": ("fraud", grids([r["fraud"]["out"]]))}
        outs.update({f"dashboard/{q}": ("dashboard", trend_head(q, g))
                     for q, g in d["outs"].items() if not is_vol_head(q)})
        return exact, outs
    if name == "late_data":
        exact = {k: r[k] for k in ("events", "sealed_chunks", "late",
                                   "revised", "corrections",
                                   "revision_units", "revision_chunks")}
        return exact, {"fraud": ("fraud", (r["valid"], {"v": r["value"]}))}
    if name == "metrics_observability":
        snap = r["snapshot"]
        c, g = snap["counters"], snap["gauges"]
        exact = {k: c[k]["value"] for k in ("runner.chunks", "runner.units",
                                            "runner.dirty_units")}
        exact["runner.compact"] = g["runner.compact"]["value"]
        exact["bucket_picks"] = r["bucket_picks"]
        exact["retraces"] = r["compiles"]["retraces"]
        # integer-valued data: the outputs are exact too
        return exact, {"outputs": (None, grids(r["outs"]))}
    if name == "plan_audit":
        exact = {"verdict": r["verdict"],
                 "findings": findings_key(r["findings"]),
                 "demand": tuple(r["demand"]),
                 "contract": tuple(r["contract"]),
                 "bad_verdict": r["bad_verdict"],
                 "bad_findings": findings_key(r["bad_findings"])}
        return exact, {}
    if name == "serving_loop":
        exact = {k: r[k] for k in ("plan_source", "event_plan_source",
                                   "admitted", "sealed_chunks", "shed")}
        exact["chunks"] = len(r["outs"])
        return exact, {"chunks": ("fraud", grids(r["outs"])),
                       "sealed": ("fraud", grids(r["sealed"]))}
    raise KeyError(name)


def hold(name: str, got: tuple, want: tuple) -> dict:
    """Hold ``got = figures(...)`` against ``want``: the exact figures
    equal, each output within its tolerance entry (bit for bit where the
    entry is None).  Raises AssertionError; returns each output's
    comparison."""
    (ge, go), (we, wo) = got, want
    if ge != we:
        diff = {k: (ge.get(k), we.get(k)) for k in set(ge) | set(we)
                if ge.get(k) != we.get(k)}
        raise AssertionError(f"{name}: figures differ (got, want): {diff}")
    if go.keys() != wo.keys():
        raise AssertionError(f"{name}: outputs {sorted(go)} vs "
                             f"{sorted(wo)}")
    out = {}
    for label, (entry, (gv, gl)) in go.items():
        wv, wl = wo[label][1]
        if entry is None:
            if not np.array_equal(gv, wv) or gl.keys() != wl.keys() or any(
                    not np.array_equal(gl[k][gv], wl[k][wv]) for k in gl):
                raise AssertionError(f"{name}/{label}: not bit for bit")
            out[label] = {"max_abs_diff": 0.0, "flips": 0}
        else:
            out[label] = tolerance.compare(entry, gv, gl, wv, wl)
    return out


def hold_vol_heads_solo(r: dict, consts: dict, n_users: int, dev) -> int:
    """``multikey_analytics``' breakout and momentum heads against the
    port's own solo ``Runner`` of each query on the same data, bit for bit
    (session ≡ solo).  Returns the number of heads held."""
    from repro_torch.core import compile as qc
    from repro_torch.data import apps as A
    from repro_torch.engine import ExecPolicy, Runner, keyed_grid
    n_ticks, n_parts = consts["N_TICKS"], consts["N_PARTS"]
    data = A.dashboard_keyed_input(n_users, n_ticks, seed=3)["in"]
    grid = {"in": keyed_grid(np.asarray(data["value"], np.float32),
                             data["valid"], device=dev)}
    outs = r["dashboard"]["outs"]
    n = 0
    for q, node in A.dashboard_queries(len(outs), keyed=True).items():
        if not is_vol_head(q):
            continue
        exe = qc.compile_query(node.node, out_len=n_ticks // n_parts)
        solo = Runner(exe, ExecPolicy(keys="vmapped"), n_keys=n_users).run(
            grid, n_parts)
        hold(f"dashboard/{q} session vs solo",
             ({}, {q: (None, grids([outs[q]]))}),
             ({}, {q: (None, grids([solo]))}))
        n += 1
    return n
