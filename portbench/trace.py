"""A torch.profiler Chrome trace reduced to what the per-layer metrics read.

The traced window is the harness's own span `portbench.traced` around
whole calls. Device activity is every kernel, copy and fill on the
device; busy time is the length of their union inside the window, and
the gaps of that union are labelled by the innermost torch op running
on the host at the gap's middle, or `host` where none is.
"""

from __future__ import annotations

import json
import re

WINDOW_SPAN = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters; a copy's or fill's kind ("Memcpy HtoD")."""
    if name.startswith(("Memcpy", "Memset")):
        return name.split(" (")[0]
    name = re.sub(r"^void\s+", "", name.strip())
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        if depth == 0:
            out.append(ch)
        if ch in ">)":
            depth = max(0, depth - 1)
    return "".join(out).strip().rsplit("::", 1)[-1] or name


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: list[dict]) -> dict | None:
    """The reduction of a trace's events; None without the window span."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    if not spans:
        return None
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, kernels, ops = [], {}, {}
    cpu = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, a = e.get("cat"), float(e["ts"])
        b = a + float(e["dur"])
        if cat == "cpu_op":
            cpu.append((a, b, e.get("name", "")))
            continue
        if cat not in DEVICE_CATS:
            continue
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = e.get("name", "")
        label = short_name(name)
        ops[label] = ops.get(label, 0.0) + (b - a) * 1e-6
        if cat == "kernel":
            n, s = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, s + (b - a) * 1e-6)
    busy = _union(dev)
    gaps, edge = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        inside = [c for c in cpu if c[0] <= mid <= c[1]]
        label = max(inside, key=lambda c: c[0])[2] if inside else "host"
        labelled.append([label, (b - a) * 1e-6])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": labelled,
    }


def reduce_file(path: str) -> dict | None:
    with open(path) as fh:
        return reduce_events(json.load(fh).get("traceEvents", []))
