#!/usr/bin/env python3
"""Times of ``prefix_scan`` and ``fused_trend`` on a card, three ways.

    python3 tools/scan_trend_times.py [ROOT ...]

For each checkout ROOT (default: this one) it imports ``repro_torch`` from
``ROOT/src`` in a process of its own, builds that checkout's kernels, and
times both wrappers at chip_smoke's shapes:

* ``prefix_scan`` on 0/1 rows of (2, 2**20 + 9) (one-shot partitions) and
  (8192, 4096 + 9) (keyed batches);
* ``fused_trend`` on a 2**24-tick random walk at w = 20, 50.

Each line gives the CUDA-event mean per call (median of 7 runs of 10), the
device time per call by ``torch.profiler`` (every device event in a window
of 20 calls, so a memset a wrapper issues counts too) and the wrapper's
host time per call (1000 calls, no synchronize inside).  For a checkout
that has the single-launch ``prefix_scan`` (``window_reduce.prefix_plan``)
it also gives the host time of each part of both wrappers.  Give several
roots to compare them in one call on one card, in the order given.
"""
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def device_by_name(fn, calls: int = 20) -> dict:
    """Device ms per call of each device event name (kernel or memset) in
    ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.split("(")[0].split("<")[0][-40:]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / calls for k, v in out.items()}


def measure(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import window_reduce as wr
    from repro_torch.kernels.build import library
    assert Path(wr.__file__).resolve().is_relative_to(root.resolve())
    library.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = {"root": str(root), "card": cs.card_line()}
    for label, (R, T) in (("single", (2, cs.PART + 9)),
                          ("keyed", (2 * cs.KEYS, cs.KEY_TICKS + 9))):
        x = (torch.rand(R, T, generator=gen) < 0.33).float().to(dev)
        fn = lambda: wr.prefix_scan(x)
        out[f"prefix_scan {label} ({R},{T})"] = {
            "ms": cs.cuda_ms(fn), "device_ms": cs.kernel_device_ms(fn, ""),
            "host_ms": cs.host_ms(fn), "by_name": device_by_name(fn)}
    T = cs.N_TICKS
    x = (100.0 + torch.cumsum(torch.randn(T, generator=gen) * 0.05,
                              0)).float().to(dev)
    fn = lambda: fq.fused_trend(x, 20, 50)
    out["fused_trend (2**24,) w=20,50"] = {
        "ms": cs.cuda_ms(fn), "device_ms": cs.kernel_device_ms(fn, ""),
        "host_ms": cs.host_ms(fn)}
    if hasattr(wr, "prefix_plan"):
        out["host parts"] = host_parts(cs, wr, fq, dev, gen)
    return out


def host_parts(cs, wr, fq, dev, gen) -> dict:
    """Host ms per call of the parts of each wrapper (1000 calls each):
    the allocations, the plan, the stream handle, and the C entry alone
    with its launch."""
    import torch
    from repro_torch.kernels.build import launch_stream
    x = (torch.rand(2, cs.PART + 9, generator=gen) < 0.33).float().to(dev)
    dev = x.device          # with its index, as the wrappers see it
    R, T = x.shape
    plan = wr.prefix_plan(R, T)
    lib = wr._prefix_lib()
    out = torch.empty((R, T), device=dev)
    scratch = torch.empty(plan.scratch, dtype=torch.int64, device=dev)
    stream = launch_stream(dev)
    xt = torch.randn(cs.N_TICKS, generator=gen).to(dev)
    tp = fq.trend_plan(cs.N_TICKS, 50)
    flib = fq._trend_lib()[0]
    up = torch.empty(cs.N_TICKS, dtype=torch.bool, device=dev)
    d = torch.empty(cs.N_TICKS, device=dev)
    parts = {
        "torch.empty (R, T) f32": lambda: torch.empty((R, T), device=dev),
        "torch.empty + slice + view": lambda: torch.empty(
            516 + R * T, device=dev)[516:].view(R, T),
        "prefix_plan": lambda: wr.prefix_plan(R, T),
        "launch_stream": lambda: launch_stream(dev),
        "input checks": lambda: wr._check(x, "prefix_scan",
                                          (torch.float32, torch.bfloat16)),
        "C entry, memset + launch": lambda: lib.wr_prefix_scan(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), R, T, 0, 1,
            plan.blocks, plan.threads, plan.tiles, plan.smem, dev.index,
            stream),
        "prefix_scan wrapper": lambda: wr.prefix_scan(x),
        "trend: C entry, launch": lambda: flib.ft_fused_trend(
            xt.data_ptr(), d.data_ptr(), up.data_ptr(), cs.N_TICKS, 20, 50,
            tp.span, tp.blocks, tp.smem, dev.index, stream),
        "fused_trend wrapper": lambda: fq.fused_trend(xt, 20, 50),
    }
    return {k: cs.host_ms(fn) for k, fn in parts.items()}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(Path(sys.argv[2]))), flush=True)
        return 0
    roots = [Path(a) for a in sys.argv[1:]] or [HERE]
    rc = 0
    for root in roots:
        res = subprocess.run([sys.executable, __file__, "--one", str(root)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(f"{root}: failed\n{res.stdout[-3000:]}{res.stderr[-3000:]}")
            rc = 1
            continue
        r = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{root} [{r.pop('root') and r.pop('card')}]")
        parts = r.pop("host parts", None)
        for k, v in r.items():
            dms = ("not reported" if v["device_ms"] is None
                   else f"{v['device_ms']:.5f}")
            print(f"  {k}: event {v['ms']:.5f} ms, device {dms} ms, "
                  f"host {v['host_ms']:.5f} ms per call" + "".join(
                      f"; {n} {t:.5f}" for n, t in v.get("by_name",
                                                        {}).items()))
        if parts:
            print("  host ms per call by part: " + "; ".join(
                f"{k} {v:.5f}" for k, v in parts.items()))
    return rc


if __name__ == "__main__":
    sys.exit(main())
