"""Reading a ``torch.profiler`` trace of one stretch of chunks.

The stretch runs inside ``torch.profiler.record_function(WINDOW)``; its
span on the host gives the window in the trace's clock.  From the device
events inside it come the busy time (the union of kernel, copy and set
intervals), the device time of each kernel by name, and the idle gaps,
each labelled by what the host was doing in its middle: the innermost
host event (a runtime call, an operator or one of the benchmark's own
spans) that covers it.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Tuple

__all__ = ["WINDOW", "kernel_name", "profiled", "read", "top"]

WINDOW = "tiltbench.window"


def kernel_name(raw: str) -> str:
    """A device event's kernel name without its namespace, template and
    parameters; a mangled name (``_Z...``) is cut to its innermost
    identifier."""
    if raw.startswith("_Z"):
        i, parts = (3 if raw.startswith("_ZN") else 2), []
        while i < len(raw) and raw[i].isdigit():
            j = i
            while j < len(raw) and raw[j].isdigit():
                j += 1
            n = int(raw[i:j])
            parts.append(raw[j:j + n])
            i = j + n
        if parts:
            return parts[-1][:48]
    short = raw.replace("(anonymous namespace)::", "")
    short = short.removeprefix("void ").split("<")[0].split("(")[0]
    return short.split("::")[-1].strip()[:48]


@contextlib.contextmanager
def profiled(box: list):
    """Profile the body (host and device activity) inside the ``WINDOW``
    span; the profile is appended to ``box`` when the body has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
    box.append(prof)


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, list]:
    busy, merged = 0.0, []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                busy += b - merged[-1][1]
                merged[-1][1] = b
        else:
            busy += b - a
            merged.append([a, b])
    return busy, merged


def read(prof) -> Dict:
    """``{window_s, busy_s, kernels: {name: [seconds, launches]},
    idle: {host activity: seconds}}`` of the stretch ``prof`` profiled
    (times in seconds)."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW
           and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError("the profile holds no window span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    spans, kernels = [], {}
    host = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if _annotation(e):
                continue
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            spans.append((a, b))
            k = kernel_name(e.name)
            s = kernels.setdefault(k, [0.0, 0])
            s[0] += (b - a) / 1e6
            s[1] += 1
        elif e.name != WINDOW and b > a:
            host.append((a, b, e.name))
    busy, merged = _union(spans)
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = {}
    edge = w0
    for a, b in merged + [[w1, w1]]:
        if a > edge:
            idle_label = _host_at(host, starts, (edge + a) / 2)
            idle[idle_label] = idle.get(idle_label, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernels": kernels, "idle": idle}


def _annotation(e) -> bool:
    """A host span mirrored onto the device timeline (a
    ``record_function`` range), which is no work on the card."""
    return bool(getattr(e, "is_user_annotation", False)) or \
        e.name.startswith("tiltbench.")


def _host_at(host, starts, t: float, reach: int = 4096) -> str:
    """The innermost host event that covers ``t``: of the events that
    started before it and are still running, the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        a, b, name = host[j]
        if b >= t:
            return name
    return "host idle"


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    """The ``n`` largest entries of ``{name: seconds}``, largest first."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
