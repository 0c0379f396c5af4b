"""Entry points of the port on tiny shapes: the counterpart of the JAX
package's `__graft_entry__.py`.

    entry()              -> (fn, example_args): the whole-index mapping step
                            (ops/map.map_batch with its config) on a panel
                            of 3 random 300 bp genomes and 1,024 of genome
                            0's k-mers, drawn from seed 0 as the JAX entry
                            draws them, on distributed.rank_device() (the
                            card, or the CPU under BRONKO_PLATFORM=cpu);
    dryrun_multichip(n)  -> n rank processes on localhost, joined over
                            torch.distributed by the three flags, on a DxG
                            mesh factored as JAX factors it (2 genome
                            shards when n is even and at least 4): the
                            sharded map + merge step and the tally step on
                            64 k-mers a data row, then JAX's seven engine
                            runs (dxg, batchwise, the single-device
                            baseline, d1, pair_single, pair_mesh, and
                            bsplit on a small panel) with its asserts; rank
                            0 prints JAX's summary line, each run's layouts
                            in it. Exits 1 when a rank fails.

    python -m bronko_tpu_torch.entry [--ranks N]

runs entry()'s function once and then dryrun_multichip(N) (default: 4, or
the host's cards when it has more). At N = 2, as in JAX's, every mesh run
of the dry run but the small panel's spans several batches and takes the
batchwise layout, so its check that the routed layout engaged fails.
With --coordinator, --num-processes and --process-id (and --work) the
module is one rank of the dry run instead.
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bronko_tpu_torch.call import engine
from bronko_tpu_torch.config import CallConfig, platform
from bronko_tpu_torch.index.build import build_index
from bronko_tpu_torch.index.layout import build_device_index
from bronko_tpu_torch.ops.codec import from_u64, pack_kmer, seq_bytes_to_bits
from bronko_tpu_torch.ops.map import make_map_config, map_batch
from bronko_tpu_torch.parallel import distributed
from bronko_tpu_torch.parallel.distributed import init_distributed, rank_device, shutdown
from bronko_tpu_torch.parallel.mesh import make_mesh
from bronko_tpu_torch.parallel.pipeline import (
    merge_step, sharded_map_step, sharded_tally_step, split_index, upload_shard,
)

log = logging.getLogger("bronko")

K = 21
DRYRUN_TIMEOUT = 600  # seconds for the dry run's rank processes
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_panel(n_genomes: int, seq_len: int, seed: int):
    """n_genomes independent random genomes from `seed`, and the generator
    after them (JAX __graft_entry__._tiny_index's draws)."""
    rng = np.random.default_rng(seed)
    seqs = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=seq_len))
            for _ in range(n_genomes)]
    return seqs, rng


def _write_panel(folder: str, seqs: list[bytes]) -> list[str]:
    """Genome g as `folder`/g<g>.fasta, its one sequence named seq<g>."""
    os.makedirs(folder, exist_ok=True)
    paths = []
    for g, seq in enumerate(seqs):
        paths.append(os.path.join(folder, f"g{g}.fasta"))
        with open(paths[-1], "w") as fh:
            fh.write(f">seq{g}\n{seq.decode()}\n")
    return paths


def _example_kmers(index, rng, n: int = 1024):
    """n k-mers of genome 0 at random windows and counts 3..99 (JAX
    __graft_entry__._example_kmers)."""
    seq = index.files[0].sequences[0].seq
    bits = seq_bytes_to_bits(seq)
    starts = rng.integers(0, len(seq) - index.k + 1, size=n)
    kmers = pack_kmer(np.stack([bits[s:s + index.k] for s in starts]), index.k)
    return kmers, rng.integers(3, 100, size=n).astype(np.int32)


def entry():
    """(fn, example_args): fn(*example_args) is map_batch on the tiny panel:
    (kmers, counts, keys_ordered, offsets, the global postings, a zero
    (4, T+1, 4) pileup, zero (G, 3) tallies) -> (pileup, tallies)."""
    device = rank_device()
    seqs, rng = _tiny_panel(3, 300, 0)
    with tempfile.TemporaryDirectory(prefix="bronko_entry_") as tmp:
        index = build_index(K, _write_panel(tmp, seqs))
    dev = build_device_index(index, device)
    cfg = dev.map_config(n_fixed=2, use_full_kmer=False)
    kmers, counts = _example_kmers(index, rng)
    args = (from_u64(kmers, device), torch.from_numpy(counts).to(device),
            dev.keys_ordered, dev.offsets, dev.global_postings(),
            torch.zeros((4, dev.total_len + 1, 4), dtype=torch.int32, device=device),
            torch.zeros((dev.num_genomes, 3), dtype=torch.int32, device=device))
    return functools.partial(map_batch, cfg=cfg), args


def _factor(n_devices: int) -> tuple[int, int]:
    """(D, G): 2 genome shards when n is even and at least 4, the rest
    data-parallel (JAX dryrun_multichip)."""
    n_genome = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return n_devices // n_genome, n_genome


def _write_reads(path: str, seq: str, step: int, length: int, tag: str) -> None:
    with open(path, "w") as fh:
        for i in range(0, max(1, len(seq) - length), step):
            r = seq[i:i + length]
            fh.write(f"@{tag}{i}\n{r}\n+\n{'I' * len(r)}\n")


def _write_inputs(work: str, n_devices: int) -> None:
    """The dry run's files, drawn as JAX's: the panel of max(4, G) random
    5 kb genomes (seed 0), reads of genome 0 every 7 bp, a pair of mates
    every 11 bp, and the small panel (one 120 bp genome, seed 3) with
    reads every 3 bp."""
    _, n_genome = _factor(n_devices)
    seqs, _ = _tiny_panel(max(4, n_genome), 5000, 0)
    _write_panel(os.path.join(work, "panel"), seqs)
    seq = seqs[0].decode()
    _write_reads(os.path.join(work, "reads.fastq"), seq, 7, 80, "r")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    with open(os.path.join(work, "r1.fastq"), "w") as f1, \
            open(os.path.join(work, "r2.fastq"), "w") as f2:
        for i in range(0, max(1, len(seq) - 160), 11):
            r1 = seq[i:i + 80]
            r2 = "".join(comp[c] for c in reversed(seq[i + 80:i + 160]))
            f1.write(f"@p{i}/1\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@p{i}/2\n{r2}\n+\n{'I' * len(r2)}\n")
    small, _ = _tiny_panel(1, 120, 3)
    _write_panel(os.path.join(work, "small"), small)
    _write_reads(os.path.join(work, "reads_small.fastq"), small[0].decode(), 3, 60, "s")


def _read(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def _dryrun_rank(work: str, n_devices: int) -> None:
    """One rank of the dry run (JAX dryrun_multichip's body, its asserts on
    the files on rank 0, which writes them)."""
    device = rank_device()
    rank, _ = distributed.world()
    primary = rank == 0
    n_data, n_genome = _factor(n_devices)
    mesh = make_mesh(n_data, n_genome)
    seqs, rng = _tiny_panel(max(4, n_genome), 5000, 0)
    index = build_index(K, [os.path.join(work, "panel", f"g{g}.fasta")
                            for g in range(len(seqs))])
    sharded = split_index(index, n_genome)
    cfg = make_map_config(k=index.k, max_bucket=sharded.max_bucket,
                          num_genomes=sharded.num_genomes, total_len=sharded.t_pad,
                          n_fixed=2, use_full_kmer=False)
    shard = upload_shard(sharded.shards[mesh.g], sharded.tally_mode(), device, postings=True)
    per_row = 64
    kmers, counts = _example_kmers(index, rng, n=per_row * n_data)
    own = slice(mesh.d * per_row, (mesh.d + 1) * per_row)
    km, ct = from_u64(kmers[own], device), torch.from_numpy(counts[own]).to(device)
    pileup = torch.zeros((4, sharded.t_pad + 1, 4), dtype=torch.int32, device=device)
    tallies = torch.zeros((sharded.num_genomes, 3), dtype=torch.int32, device=device)
    pileup, tallies = sharded_map_step(km, ct, shard, pileup, tallies, cfg=cfg, mesh=mesh)
    _, tallies = merge_step(pileup, tallies, mesh)
    total = int(tallies.sum())
    assert total > 0, "dryrun mapped no kmers"
    tally_sum = int(sharded_tally_step(km, ct, shard, cfg, mesh).sum())
    assert tally_sum > 0
    mesh.close()

    layouts: dict[str, set] = {}
    host = torch.device("cpu")
    devs = {}

    def run(name: str, idx, mesh_shape: str | None, batch: int, **inputs):
        """run_call of the product path; a mesh run's layouts recorded."""
        key = (id(idx), mesh_shape is not None or device == host)
        if key not in devs:
            devs[key] = build_device_index(idx, host if key[1] else device)
        cfg = CallConfig(db="graft", output=os.path.join(work, f"out_{name}"),
                         mesh=mesh_shape, batch_size=batch, chunk_reads=4096, **inputs)
        results = engine.run_call(cfg, idx, devs[key], device)
        if mesh_shape:
            layouts[name] = set(engine.LAST_MESH_LAYOUTS)
        return results, cfg.output

    def vcf(out: str, name: str) -> str:
        return _read(os.path.join(out, name))

    reads = [os.path.join(work, "reads.fastq")]
    dxg = f"{n_data}x{n_genome}"
    results, out = run("dxg", index, dxg, 1024 * n_devices, reads=reads)
    assert results and results[0].summary.n_perfect > 0
    n_perfect = results[0].summary.n_perfect
    _, out_bw = run("batchwise", index, dxg, 8 * n_devices, reads=reads)
    if primary:
        assert vcf(out, "reads.vcf"), "engine produced no VCF"
        assert vcf(out, "reads.vcf") == vcf(out_bw, "reads.vcf"), \
            "batchwise mesh layout diverged from B-split"
        _, out_sd = run("sd", index, None, 1024 * n_devices, reads=reads)
        assert vcf(out, "reads.vcf") == vcf(out_sd, "reads.vcf"), \
            "mesh output diverged from single-device baseline"
    _, out_d1 = run("d1", index, f"{n_devices}x1", 1024 * n_devices, reads=reads)
    if primary:
        assert vcf(out, "reads.vcf") == vcf(out_d1, "reads.vcf"), \
            "Dx1 mesh layout diverged from DxG"
    d1_hist = split_index(index, 1).tally_mode() == "hist"
    dxg_hist = sharded.tally_mode() == "hist"

    pairs = dict(first_pairs=[os.path.join(work, "r1.fastq")],
                 second_pairs=[os.path.join(work, "r2.fastq")])
    if primary:
        _, out_p1 = run("pair_single", index, None, 1024, **pairs)
    _, out_pm = run("pair_mesh", index, dxg, 1024 * n_devices, **pairs)
    if primary:
        assert vcf(out_p1, "r1.vcf") == vcf(out_pm, "r1.vcf"), \
            "paired mesh run diverged from single-device"

    small = build_index(K, [os.path.join(work, "small", "g0.fasta")])
    reads_s = [os.path.join(work, "reads_small.fastq")]
    _, out_bs = run("bsplit", small, f"{n_devices}x1", 1024 * n_devices, reads=reads_s)
    if primary:
        _, out_bs0 = run("bs0", small, None, 1024 * n_devices, reads=reads_s)
        assert vcf(out_bs, "reads_small.vcf") == vcf(out_bs0, "reads_small.vcf"), \
            "B-split mesh run diverged from single-device"
    assert layouts.get("bsplit") == {"bsplit"}, \
        f"small-panel run did not take the B-split layout: {layouts}"
    assert "routed" in layouts.get("dxg", set()) | layouts.get("d1", set()), \
        f"routed layout never engaged in a single-batch mesh run: {layouts}"

    all_layouts = sorted(set().union(*layouts.values()))
    per_run = ", ".join("{}={}".format(n, "+".join(sorted(v))) for n, v in sorted(layouts.items()))
    if primary:
        print(f"dryrun_multichip({n_devices}): mesh=({n_data} data x {n_genome} genome), "
              f"panel={len(index.files)}x5kb, "
              f"tallies sum={total}, sharded-tally sum={tally_sum}, "
              f"sharded engine: {n_perfect} perfect kmers, VCF written: OK, "
              f"layouts: {'+'.join(all_layouts)} (per-run: {per_run}), "
              f"mesh vs single-device (no mesh): byte-identical, "
              f"batchwise layout: byte-identical, "
              f"Dx1 (hist={d1_hist}): byte-identical, "
              f"DxG tally mode: {'hist' if dxg_hist else 'flat'}, "
              f"paired mesh vs single-device: byte-identical", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> str:
    """Start n_devices rank processes of this module on localhost (the
    three flags; gloo when they share a card or run on the CPU, as
    distributed.py chooses), wait for them, and print and return rank 0's
    summary line. Raises SystemExit(1), after logging the failing ranks'
    last output, when any rank exits non-zero or runs past
    DRYRUN_TIMEOUT."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    with tempfile.TemporaryDirectory(prefix="bronko_dryrun_") as work:
        _write_inputs(work, n_devices)
        port = _free_port()
        logs = [os.path.join(work, f"rank{r}.log") for r in range(n_devices)]
        procs = []
        for r in range(n_devices):
            with open(logs[r], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bronko_tpu_torch.entry", "--work", work,
                     "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n_devices),
                     "--process-id", str(r)], env=env, stdout=fh, stderr=subprocess.STDOUT))
        t0 = time.perf_counter()
        try:
            for p in procs:
                p.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            log.error("dryrun_multichip(%d): ranks ran past %d s", n_devices, DRYRUN_TIMEOUT)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = [_read(path) for path in logs]
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        for r in failed:
            log.error("dryrun_multichip(%d): rank %d exited %s:\n%s", n_devices, r,
                      procs[r].returncode, texts[r][-4000:])
        lines = [ln for ln in texts[0].splitlines() if ln.startswith("dryrun_multichip(")]
        if failed or not lines:
            raise SystemExit(1)
    print(lines[-1], flush=True)
    return lines[-1]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="The port's entry() and dryrun_multichip(n)")
    cards = torch.cuda.device_count() if platform() == "gpu" else 0
    parser.add_argument("--ranks", type=int, default=max(4, cards),
                        help="rank processes of the dry run (default: 4, or the host's cards)")
    parser.add_argument("--work", help="(a rank of the dry run) its input folder")
    parser.add_argument("--coordinator", help="(a rank of the dry run) rendezvous host:port")
    parser.add_argument("--num-processes", type=int, help="(a rank of the dry run) ranks")
    parser.add_argument("--process-id", type=int, help="(a rank of the dry run) this rank")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    if args.coordinator is not None:
        init_distributed(args.coordinator, args.num_processes, args.process_id)
        try:
            _dryrun_rank(args.work, args.num_processes)
        finally:
            shutdown()
        return 0
    fn, example_args = entry()
    pileup, tallies = fn(*example_args)
    print(f"entry(): run OK on {pileup.device}: tallies sum {int(tallies.sum())}, "
          f"pileup count planes sum {int(pileup[2:].sum())}", flush=True)
    dryrun_multichip(args.ranks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
