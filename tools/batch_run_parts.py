#!/usr/bin/env python3
"""Where a staged ``batch_run`` call spends its time against the eager
call, on a card: the keyed apps at 4096 keys x 4096 ticks.

    python3 tools/batch_run_parts.py [APP ...]      (default: every keyed app)

For each app, CUDA-event spans on the current stream (the smallest of
``REPS``, after two untimed calls) and host-clock walls of:

* ``eager``: ``batch_run`` of the query compiled with ``jit=False``;
* ``staged``: ``batch_run`` of the default (staged) query, whole;
* ``load``: its copy of the grids between the zero halos of its static
  buffers;
* ``replay``: its graph replayed alone (the query);
* ``copy out``: the copies of its outputs handed to the caller;
* ``pad``: the eager halo pads alone (``F.pad`` of every input leaf);
* ``body``: the eager query alone, on inputs padded beforehand;
* ``pad in graph``: another staging, for comparison: the raw grids
  copied into static buffers of their own shapes, the pads made by
  ``F.pad`` inside the graph.

Prints one line per app and part, with the card's name and power limit.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KEYS, TICKS, REPS = 4096, 4096, 20


def _span_ms(fn) -> float:
    import torch
    spans = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        spans.append(a.elapsed_time(b))
    return min(spans)


def _wall_ms(fn) -> float:
    import torch
    walls = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return min(walls)


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.utils._pytree import tree_leaves, tree_map
    if not torch.cuda.is_available():
        print("batch_run_parts: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import compile as qc
    from repro_torch.core.parallel import batch_run
    from repro_torch.data import apps as A
    from repro_torch.engine import capture
    from repro_torch.kernels.build import library
    library.load()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    for name in sys.argv[1:] or A.KEYED_APPS:
        app = A.make_keyed_app(name)
        grids = A.make_grids(app.make_keyed_input(KEYS, TICKS, 0), device=dev)
        exe, eager = (qc.compile_query(app.query.node, jit=jit,
                                       out_len=TICKS // app.query.prec)
                      for jit in (True, False))
        specs = exe.input_specs
        raw = {nm: (grids[nm].value, grids[nm].valid) for nm in specs}

        def pad(r):
            return {nm: tree_map(lambda x, s=s: F.pad(
                x, (s.left_halo, s.right_halo)), r[nm])
                for nm, s in specs.items()}

        padded = pad(raw)
        for _ in range(2):
            batch_run(exe, grids)
            batch_run(eager, grids)
        (ent,) = exe._batch_stage.entries.values()
        (bufs,) = ent.inputs
        out = ent.run()

        def load():
            for nm, s in specs.items():
                for d, x in zip(tree_leaves(bufs[nm]), tree_leaves(raw[nm])):
                    d[..., s.left_halo:s.left_halo + x.shape[-1]].copy_(x)

        in_graph = capture.Staged(lambda r: exe.trace_fn(pad(r)))

        parts = {
            "eager": lambda: batch_run(eager, grids),
            "staged": lambda: batch_run(exe, grids),
            "load": load,
            "replay": ent.run,
            "copy out": lambda: tree_map(
                lambda x: x.clone() if torch.is_tensor(x) else x, out),
            "pad": lambda: pad(raw),
            "body": lambda: exe.trace_fn(padded),
            "pad in graph": lambda: in_graph(raw),
        }
        nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(raw))
        print(f"{name}: inputs {nbytes / 2**20:.1f} MiB, halos "
              + ", ".join(f"{nm} ({s.left_halo}, {s.right_halo})"
                          for nm, s in specs.items()))
        for part, fn in parts.items():
            for _ in range(2):
                fn()
            print(f"  {part:12s}: span {_span_ms(fn):.4f} ms, wall "
                  f"{_wall_ms(fn):.4f} ms")
        del grids, raw, padded, out, ent, bufs, exe, eager, in_graph
    return 0


if __name__ == "__main__":
    sys.exit(main())
