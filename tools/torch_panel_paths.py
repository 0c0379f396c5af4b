"""Time the port's large-panel paths of one checkout on a CUDA card, and
count their host syncs.

    python tools/torch_panel_paths.py [--repo DIR] [--reps N] [--tag NAME]

Runs the `bronko_tpu_torch` package of DIR (default: this checkout; for
another one, unpack it with `git archive` into a directory `.gitignore`
lists) on chip_smoke.py's 32-strain panel and sample s0 (drawn into
.smoke_cache/ when missing, ~140 s, and the panel's strains written
there), on the index laid out from the host build. The passes are
chip_smoke.py's own (`panel_passes`: the words path's pass 1 and pass 2
for strain 17, the flat tally's pass 1 and the sub-index pass 2, each
ending in a host sync), one cold run and N warm ones of each path in
turns (`time_panel_passes`, default 7), wall seconds. Host syncs are
counted with torch.cuda.set_sync_debug_mode('warn') around one flat
tally of the sample's batches and one probe_scatter batch over the whole
index, each enqueued without the final copy. Prints one JSON line with
the medians, quartiles and sync counts, the card's name and power limit,
and the checkout. Several checkouts are compared in turns by running the
script once for each, in one call on one card (parent, change, change,
parent).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=HERE, help="the checkout whose package is timed")
    parser.add_argument("--reps", type=int, default=7, help="warm runs of each path")
    parser.add_argument("--tag", default="", help="a name for the checkout in the output")
    args = parser.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from bronko_tpu_torch.call import engine
    from bronko_tpu_torch.index.build import build_index
    from bronko_tpu_torch.index.layout import build_device_index
    from bronko_tpu_torch.ops import cuda_lib
    from bronko_tpu_torch.ops import map as tmap

    # the fixture and the panel come from this checkout's chip_smoke.py
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_lib.build()
    genome_paths, fastqs, _ = smoke.make_fixture()
    paths = smoke.make_panel(genome_paths[0])
    gpu = torch.device("cuda", 0)
    dev = build_device_index(build_index(21, paths), gpu)
    os.environ["BRONKO_PLATFORM"] = "gpu"
    cfg = smoke.call_args(paths, fastqs[0], os.path.join(HERE, ".smoke_cache", "paths"), "host")
    counted = engine._count_job([fastqs[0]], cfg, cfg.kmer, gpu)
    batches = engine.to_batches(counted.kmers, counted.counts, cfg.batch_size, gpu)
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
    passes = smoke.panel_passes(dev, batches, mcfg)
    for run in passes.values():  # the cold run of each
        run()
    times = smoke.time_panel_passes(passes, args.reps)
    seconds = {f"{name} pass {j + 1}": [t[j] for t in runs]
               for name, runs in times.items() for j in (0, 1)}

    postings = dev.global_postings()
    zero = torch.zeros((4, dev.total_len + 1, 4), dtype=torch.int32, device=gpu)
    kmers, counts = batches[0]
    syncs = {}
    for name, fn in (("flat tally", lambda: tmap.tally(batches, dev, mcfg, "flat")),
                     ("probe_scatter", lambda: tmap.probe_scatter(
                         kmers, counts, dev.keys_ordered, dev.offsets, postings, zero,
                         cfg=mcfg))):
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # torch's own warning that the debug mode is a prototype is not a sync
        syncs[name] = sum("called a synchronizing" in str(w.message) for w in caught)
        torch.cuda.synchronize()

    def stats(xs):
        q1, med, q3 = statistics.quantiles(xs, n=4)
        return {"median": med, "q1": q1, "q3": q3}
    print(json.dumps({"checkout": args.tag or repo, "card": smi, "batches": len(batches),
                      "k-mers": int(counted.kmers.shape[0]), "reps": args.reps,
                      "seconds": {n: stats(v) for n, v in seconds.items()},
                      "host syncs": syncs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
