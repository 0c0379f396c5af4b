"""The control of `correct`: the plain reference put in the program's place,
its caller one precision lower (float32 for the float64 bronko states),
judged by the same comparison against the reference as it stands.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs, works every distinct sample out
with the reference twice (float64, float32 caller) on the card (on the
CPU with --cpu), and prints one JSON line: the numbers the control reads
(they have to come out above their limits), and the sound reference's
own planted majors that are not a PASS record (they have to be 0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import checks, gen, guard, harness  # noqa: E402

guard.install()


def as_program(res, name: str):
    """A reference Result in the shape of the program's SampleResult."""
    n_perfect, n_variant = int(res.tallies[res.best, 0]), int(res.tallies[res.best, 1])
    summary = SimpleNamespace(filename=name, selected_genome=res.overview[0], stats=res.stats,
                              n_perfect=n_perfect, n_variant=n_variant,
                              n_unmapped=res.unique_counted - n_perfect - n_variant)
    return SimpleNamespace(summary=summary, reads=res.reads, best=res.best,
                           tallies=res.tallies, pileup=res.pileup, records=res.records)


def readings(config: dict, traffic: dict, seed: int, device, cache: str) -> dict:
    """One seed: the control's numbers and the sound reference's misses."""
    from portbench.reference import Reference

    inputs = gen.prepare(config, traffic, seed, cache)
    ref = Reference(inputs.codes, inputs.names, int(config["k"]),
                    config.get("reference_params"), device)
    paths = [[s.r1, s.r2] for s in inputs.samples]
    t = time.perf_counter()
    sound = ref.run_many(paths)
    t_sound = time.perf_counter() - t
    low = ref.run_many(paths, ftype=np.float32)
    refs = dict(enumerate(sound))
    majors = {s.index: s.majors for s in inputs.samples}
    control = checks.compare_samples(
        [{"id": i, "name": s.r1, "result": as_program(r, s.r1)}
         for i, (s, r) in enumerate(zip(inputs.samples, low))], refs, majors)
    own = checks.compare_samples(
        [{"id": i, "name": s.r1, "result": as_program(r, s.r1)}
         for i, (s, r) in enumerate(zip(inputs.samples, sound))], refs, majors)
    return {"seed": seed, "control": control, "sound_majors_missing": own["majors"],
            "sound_self": sum(v for k, v in own.items() if k != "majors"),
            "reference_s": t_sound}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    import torch

    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    _, config, traffic = harness.load_cell(bench, args.workload)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("portbench control: no CUDA device (use --cpu)", file=sys.stderr)
        return 3
    for seed in args.seeds:
        print(json.dumps(readings(config, traffic, seed, device, harness.CACHE)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
