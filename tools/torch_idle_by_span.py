"""The card's idle time in a profiler trace of the port, split by what the
main thread was doing.

    python3 tools/torch_idle_by_span.py TRACE.json [--tid TID] [--window NAME] [--json]

TRACE.json is a torch.profiler Chrome trace of `run_call`, such as the one
`python -m bronko_tpu_torch call ... --profile-dir DIR` writes. The card is
busy while a kernel, copy or fill runs (the union of the `kernel`,
`gpu_memcpy` and `gpu_memset` events); idle is the rest of the window. The
window is the first range named `--window`, else the trace from its first
to its last event. Each idle stretch is split by the main thread's
innermost `bronko.*` range (utils/spans.py), `host` where none is open;
`bronko.sample.<n>` ranges fold into `bronko.sample.*`, and a sample's
`bronko.map.rows=<n>.batches=<n>.words=<n>` into `bronko.map`. The main thread is
`--tid`, else the thread whose id is the process id. Then, for every
thread, the seconds it spent in each `bronko.*` range (nested ranges
count at each level). A trace without device events reads all idle.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = "host"


def fold(name: str) -> str:
    name = re.sub(r"^bronko\.map\.rows=.*$", "bronko.map", name)
    return re.sub(r"^bronko\.sample\.\d+$", "bronko.sample.*", name)


def union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost(ranges):
    """[(start, end, name)] of one thread's properly nested ranges ->
    sorted disjoint [(start, end, name of the innermost range open)]."""
    segs, stack, cur = [], [], None

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][1] <= t:
            end, name = stack[-1][1], stack[-1][2]
            if end > cur:
                segs.append((cur, end, name))
                cur = end
            stack.pop()

    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        close_until(a)
        if stack and a > cur:
            segs.append((cur, a, stack[-1][2]))
        cur = a if cur is None else max(cur, a)
        stack.append((a, min(b, stack[-1][1]) if stack else b, name))
    close_until(float("inf"))
    return segs


def split_idle(idle, segs):
    """Seconds of the `idle` intervals under each segment's name; the rest
    under HOST. Both lists sorted and disjoint; times in microseconds."""
    out, j = {}, 0
    for a, b in idle:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + (hi - lo) * 1e-6
                covered += hi - lo
            k += 1
        out[HOST] = out.get(HOST, 0.0) + (b - a - covered) * 1e-6
    return out


def reduce(events: list[dict], tid=None, window: str | None = None) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    if window is not None:
        w = [e for e in xs if e.get("name") == window and e.get("cat") == "user_annotation"]
        if not w:
            raise SystemExit(f"no range named {window!r} in the trace")
        w0, w1 = float(w[0]["ts"]), float(w[0]["ts"]) + float(w[0]["dur"])
    else:
        w0 = min(float(e["ts"]) for e in xs)
        w1 = max(float(e["ts"]) + float(e["dur"]) for e in xs)
    host = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
    if tid is None:
        own = [e["tid"] for e in host if e.get("tid") == e.get("pid")]
        tid = own[0] if own else max({e["tid"] for e in host},
                                     key=lambda t: sum(e["tid"] == t for e in host))
    busy = union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                  for e in xs if e.get("cat") in DEVICE_CATS])
    busy = [(a, b) for a, b in busy if b > a]
    idle, edge = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    spans = [e for e in xs if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bronko.")]
    main = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), fold(e["name"]))
            for e in spans if e.get("tid") == tid]
    by_span = split_idle(idle, innermost(main))
    threads: dict[str, dict[str, float]] = {}
    for e in spans:
        row = threads.setdefault(str(e.get("tid")), {})
        name = fold(e["name"])
        row[name] = row.get(name, 0.0) + float(e["dur"]) * 1e-6
    idle_s = sum(b - a for a, b in idle) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "idle_s": idle_s,
        "main_tid": str(tid),
        "idle_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        "threads": threads,
    }


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="tools/torch_idle_by_span.py")
    ap.add_argument("trace")
    ap.add_argument("--tid", help="the main thread's id (default: the process id)")
    ap.add_argument("--window", help="the range that bounds the window")
    ap.add_argument("--json", action="store_true", help="print one JSON object")
    args = ap.parse_args(argv)
    with open(args.trace) as fh:
        events = json.load(fh).get("traceEvents", [])
    tid = None
    if args.tid is not None:
        tid = int(args.tid) if args.tid.lstrip("-").isdigit() else args.tid
    out = reduce(events, tid, args.window)
    if args.json:
        print(json.dumps(out))
        return 0
    print(f"window {out['window_s']:.6f} s, card busy {out['busy_s']:.6f} s, idle "
          f"{out['idle_s']:.6f} s; main thread {out['main_tid']}")
    print("idle by the main thread's innermost range:")
    for name, s in out["idle_by_span"].items():
        share = 100 * s / out["idle_s"] if out["idle_s"] else 0.0
        print(f"  {name:<28} {s:.6f} s  {share:6.2f}%")
    print("ranges by thread (s):")
    for t, row in sorted(out["threads"].items(), key=lambda kv: kv[0] != out["main_tid"]):
        tag = " (main)" if t == out["main_tid"] else ""
        print(f"  {t}{tag}: " + ", ".join(f"{n} {s:.6f}" for n, s in
                                         sorted(row.items(), key=lambda kv: -kv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
