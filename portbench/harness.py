"""One run of one cell: inputs, set-up, the measured window, the check.

Everything specific to a cell is data, found by the names in
BENCHMARK.json: `configs/<config>.json` (the deployment: strains, k, how
the index is given, the call's flags, the program's environment),
`traffic/<traffic>.json` (the samples and how calls take them), and
`metrics/<metric>.py` (a reader of the run's record for each metric).
Nothing here names a cell.

A run: make or reuse the inputs (timed apart: the benchmark's work, not
the program's); set up the program as `bronko call` would (imports, the
kernels and the native library from their build directories, the index
read or built, then the traffic's warm calls); call `run_call` in a
closed loop over whole calls until `--seconds` have passed, each call's
samples taken in turn from the distinct ones; with `--trace 1`, profile
`trace_calls` whole calls after the first. Then read the device's peak
memory, free the program's state, work every distinct sample out again
with the plain reference, compare, and print the result line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

from portbench import checks, gen, guard, roofline, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
COPY_NAMES = "abcdefghijklmnopqrstuvwxyz"


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(bench: dict, workload: str, root: str = HERE):
    """(cell, config, traffic) of `workload`, each config and mix from its
    own file, with its name added."""
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = {**load_json(os.path.join(root, "configs", f"{cell['config']}.json")),
              "name": cell["config"]}
    traffic = {**load_json(os.path.join(root, "traffic", f"{cell['traffic']}.json")),
               "name": cell["traffic"]}
    return cell, config, traffic


def cell_metrics(bench: dict, cell: dict, traced: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones untraced,
    its per-layer ones traced."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str, root: str = HERE):
    """The `read(record)` function of metrics/<name>.py."""
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def call_slots(traffic: dict, c: int) -> list[tuple[int, int]]:
    """(distinct sample, name copy) of each sample of window call c."""
    n, per, copies = int(traffic["samples"]), int(traffic["per_call"]), int(traffic["copies"])
    return [(j % n, (j // n) % copies) for j in range(c * per, (c + 1) * per)]


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def info(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, traced: bool,
             device, t_start: float, cache: str = CACHE) -> dict:
    """One run; returns the record the metric readers read, with the
    compared numbers under "checks" and the device's peak memory."""
    import torch

    from portbench.reference import Reference
    from portbench.system import System

    t0 = time.perf_counter()
    inputs = gen.prepare(config, traffic, seed, cache)
    gen_s = time.perf_counter() - t0
    parts = {"start": t0 - t_start}
    info(f"inputs: {len(inputs.strains)} strains, {len(inputs.samples)} samples of "
         f"{inputs.samples[0].pairs} pairs, made or found in {gen_s:.3f} s")

    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        out_dir = os.path.join(work, "out")
        reads_dir = os.path.join(work, "reads")
        os.makedirs(reads_dir)

        def pair(i: int, copy: int) -> tuple[str, str]:
            s, name = inputs.samples[i], f"s{i}{COPY_NAMES[copy]}"
            paths = []
            for m, target in ((1, s.r1), (2, s.r2)):
                link = os.path.join(reads_dir, f"{name}_R{m}.fastq.gz")
                if not os.path.lexists(link):
                    os.symlink(target, link)
                paths.append(link)
            return paths[0], paths[1]

        t = time.perf_counter()
        system = System(config, traffic, inputs.strains, inputs.folder, device)
        cfg = system.config_for([pair(0, 0)], out_dir)
        parts["program"] = time.perf_counter() - t
        index_setup_s = parts["index"] = system.load_index(cfg)
        info(f"index ready in {index_setup_s:.4f} s")
        t_warm = time.perf_counter()
        for ids in traffic["warm"]:
            t = time.perf_counter()
            got = system.call(system.config_for([pair(i, 0) for i in ids], out_dir))
            info(f"warm call of {len(ids)} sample(s): {len(got)} done in "
                 f"{time.perf_counter() - t:.3f} s, paths {sorted({r.path for r in got})}")

        calls, window, prof, trace_path = [], [], None, None
        trace_calls = int(traffic["trace_calls"])
        t_w0 = time.perf_counter()
        parts["warm"] = t_w0 - t_warm
        setup_s = t_w0 - t_start - gen_s
        info("set-up " + ", ".join(f"{k} {v:.4f} s" for k, v in parts.items())
             + f" (inputs {gen_s:.4f} s apart)")
        c = 0
        while True:
            slots = call_slots(traffic, c)
            pairs = [pair(i, cp) for i, cp in slots]
            cfg = system.config_for(pairs, out_dir)
            if traced and c == 1:
                prof, span = _start_profile(device)
            t_a = time.perf_counter()
            results = system.call(cfg)
            t_b = time.perf_counter()
            if prof is not None and c == trace_calls:
                trace_path = _stop_profile(prof, span, work)
                prof = None
            by_name = {r.summary.filename: r for r in results}
            samples = []
            for (i, cp), (r1, _) in zip(slots, pairs):
                r = by_name.get(r1)
                window.append({"id": i, "name": r1, "result": r})
                samples.append({
                    "id": i, "ok": r is not None, "reads": 2 * inputs.samples[i].pairs,
                    "seconds": dict(r.seconds) if r is not None else {},
                    "path": list(r.path) if r is not None else None,
                    "traced": traced and 1 <= c <= trace_calls})
            calls.append({"t0": t_a, "t1": t_b, "wall_s": t_b - t_a, "samples": samples})
            c += 1
            if time.perf_counter() - t_w0 >= seconds and (not traced or c > trace_calls):
                break
        last_call = window[-len(calls[-1]["samples"]):]
        walls = sorted(c_["wall_s"] for c_ in calls)
        q = statistics.quantiles(walls, n=4, method="inclusive") if len(walls) > 1 else walls * 3
        info(f"window: {len(calls)} calls, {len(window)} samples in "
             f"{calls[-1]['t1'] - calls[0]['t0']:.3f} s; call walls min {walls[0]:.4f}, "
             f"quartiles {q[0]:.4f} {q[1]:.4f} {q[2]:.4f}, max {walls[-1]:.4f} s; paths "
             f"{dict(Counter(str(s['path']) for c_ in calls for s in c_['samples']))}")

        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        found = guard.loaded()
        reduced = trace.reduce_file(trace_path) if trace_path else None
        G, J = system.dev.num_genomes, len(system.dev.map_config(cfg.n_fixed,
                                                                  cfg.use_full_kmer).positions)
        system.close()
        del system, results, by_name
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t = time.perf_counter()
        ref = Reference(inputs.codes, inputs.names, int(config["k"]),
                        config.get("reference_params"), device)
        ids = sorted({s["id"] for s in window})
        refs = dict(zip(ids, ref.run_many([[inputs.samples[i].r1, inputs.samples[i].r2]
                                           for i in ids])))
        ref_s = time.perf_counter() - t
        info(f"reference: {len(ids)} distinct samples in {ref_s:.3f} s")
        found_checks = checks.compare(
            window, refs, {i: inputs.samples[i].majors for i in ids},
            lambda name, i: ref.vcf(name, refs[i]), out_dir, last_call)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    return {
        "cell": cell, "config": config, "traffic": traffic, "seed": seed,
        "setup_s": setup_s, "gen_s": gen_s, "index_setup_s": index_setup_s,
        "reference_s": ref_s, "calls": calls, "trace": reduced,
        "work": {i: refs[i].work for i in ids}, "index": {"k": int(config["k"]), "J": J, "G": G},
        "checks": found_checks, "memory_peak_bytes": peak, "jax_modules": found,
    }


def _start_profile(device):
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    span = torch.profiler.record_function(trace.WINDOW_SPAN)
    span.__enter__()
    return prof, span


def _stop_profile(prof, span, work: str) -> str:
    span.__exit__(None, None, None)
    prof.stop()
    path = os.path.join(work, "trace.json")
    prof.export_chrome_trace(path)
    return path


def result_line(record: dict, metrics: list[dict], traced: bool, kind: str, chips: int) -> dict:
    """The last line's object: correct, attempted, failed, metrics,
    device, breakdown (traced), and the compared numbers last."""
    values = {}
    for m in metrics:
        v = reader(m["name"])(record)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = sum(len(c["samples"]) for c in record["calls"])
    failed = sum(not s["ok"] for c in record["calls"] for s in c["samples"])
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(record["memory_peak_bytes"])}
    line = {"correct": checks.correct(record["checks"]) and failed == 0,
            "attempted": attempted, "failed": failed, "metrics": values, "device": device}
    if traced and record["trace"] is not None:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
        line["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                             "idle_gaps": record["trace"]["idle_gaps"]}
    line["checks"] = record["checks"]
    return line


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    traced = bool(args.trace)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic = load_cell(bench, args.workload)
    metrics = cell_metrics(bench, cell, traced)
    # the deployment's own settings of the program's environment
    for part in (config, traffic):
        os.environ.update({k: str(v) for k, v in part.get("env", {}).items()})
    # kernel and compile caches of any library stay in the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    calib = os.path.join(os.path.expanduser("~"), ".cache", "bronko_torch", "stream_calib.json")
    info(f"{args.workload}: seed {args.seed}, {args.seconds:g} s, trace {args.trace}; "
         f"stream calibration file {'present' if os.path.exists(calib) else 'absent'} at "
         f"{calib}")

    record = run_cell(cell, config, traffic, args.seed, args.seconds, traced, device, t_start)
    try:
        line = result_line(record, metrics, traced, kind, chips)
    except roofline.OverRoofline as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 5
    info(f"{kind} ({smi()}); set-up {record['setup_s']:.4f} s, reference "
         f"{record['reference_s']:.3f} s, work {record['work']}")
    if traced and record["trace"]:
        ix = record["index"]
        samples = [(record["work"][s["id"]], tuple(s["path"])) for c in record["calls"]
                   for s in c["samples"] if s["traced"] and s["ok"]]
        _, detail = roofline.share(samples, roofline.kernel_seconds(record["trace"]["kernels"]),
                                   ix["k"], ix["J"], ix["G"])
        info(f"traced {len(samples)} samples; map kernels: {detail}")
    # as the window closed and again as the last thing before the result
    found = sorted(set(record["jax_modules"]) | set(guard.loaded()))
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
