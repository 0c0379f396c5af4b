"""Seeded, vectorised inputs of a cell: the strains of a configuration and
the paired-end samples of a traffic mix.

Strains (from the configuration alone, so every --seed sees the same
index): one random genome of `genome_len` bases drawn from `config_seed`,
and `strains` copies of it, each with `snps_per_strain` seeded
substitutions, except `base_strain`, which is the genome itself. Each is
written as a one-record FASTA.

Samples (from the traffic mix and --seed): `samples` distinct paired-end
samples. Sample i is drawn from strain (strain_stride * i) mod strains.
Each pair is one fragment of a uniform length in `fragment`, uniformly
placed and oriented; R1 reads its first `read_len` bases, R2 the reverse
complement of its last. `majors` planted sites carry a seeded alternative
base at `major_af` of the fragments over them, `minors` at a fraction
drawn from `minor_af`; sites lie one to each of equal bins between
`site_margin` from either end, at least `site_gap` apart. Substitution
errors hit `error_rate` of the read bases. Both mates are written as
gzip FASTQ, the form a sequencer hands over.

Everything is cached under the benchmark's own `.cache/`, keyed by the
configuration's and the traffic mix's contents and the seed, and written
through a temporary name, so an interrupted run leaves no half file.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

ASCII = np.frombuffer(b"ACGT", np.uint8)
KEEP_SEEDS = 8  # sample sets kept per configuration and mix; older ones are removed


@dataclass
class Sample:
    """One distinct sample: its mates on disk and what was planted."""
    index: int
    strain: int
    r1: str
    r2: str
    pairs: int
    planted: list  # [(0-based position, alt base code, fraction, "major" | "minor")]

    @property
    def majors(self) -> list[tuple[int, int]]:
        """(0-based position, alt base code) of each planted major."""
        return sorted((p, a) for p, a, _, kind in self.planted if kind == "major")


@dataclass
class Inputs:
    strains: list[str]    # FASTA paths, strain order
    names: list[str]      # strain names (FASTA record names and file stems)
    codes: list[np.ndarray]  # each strain's 2-bit codes
    samples: list[Sample]
    folder: str           # the configuration's cache folder


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()[:10]


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


def strain_codes(config: dict) -> list[np.ndarray]:
    """The configuration's strains as 2-bit codes (0..3 = ACGT)."""
    rng = np.random.default_rng(int(config["config_seed"]))
    L, n, snps = int(config["genome_len"]), int(config["strains"]), int(config["snps_per_strain"])
    base = rng.integers(0, 4, L, dtype=np.uint8)
    out = []
    for j in range(n):
        sites = rng.choice(L, snps, replace=False)
        shifts = rng.integers(1, 4, snps, dtype=np.uint8)
        s = base.copy()
        if j != int(config["base_strain"]):
            s[sites] = (s[sites] + shifts) % 4
        out.append(s)
    return out


def strain_names(config: dict) -> list[str]:
    n = int(config["strains"])
    width = max(2, len(str(n - 1)))
    return [f"strain{j:0{width}d}" for j in range(n)]


def fasta_bytes(name: str, codes: np.ndarray, width: int = 70) -> bytes:
    seq = ASCII[codes].tobytes()
    lines = [seq[i:i + width] for i in range(0, len(seq), width)]
    return b">" + name.encode() + b"\n" + b"\n".join(lines) + b"\n"


def _fastq(codes: np.ndarray, mate: int) -> bytes:
    """(n, read_len) codes -> FASTQ text with fixed-width headers
    @rNNNNNNN/<mate>, quality 'I' throughout."""
    n, rl = codes.shape
    digits = max(7, len(str(max(n - 1, 0))))
    head = 2 + digits + 2  # '@r' digits '/m'
    width = head + 1 + rl + 1 + 2 + rl + 1
    rec = np.empty((n, width), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    ids = np.arange(n, dtype=np.int64)
    for d in range(digits):
        rec[:, 2 + digits - 1 - d] = 48 + (ids // 10 ** d) % 10
    rec[:, 2 + digits], rec[:, 3 + digits] = ord("/"), 48 + mate
    rec[:, head] = 10
    rec[:, head + 1:head + 1 + rl] = ASCII[codes]
    at = head + 1 + rl
    rec[:, at], rec[:, at + 1], rec[:, at + 2] = 10, ord("+"), 10
    rec[:, at + 3:at + 3 + rl] = ord("I")
    rec[:, -1] = 10
    return rec.tobytes()


def _gzip(data: bytes) -> bytes:
    c = zlib.compressobj(1, zlib.DEFLATED, 31)  # gzip container, fastest level
    return c.compress(data) + c.flush()


def make_sample(strain: np.ndarray, traffic: dict, seed: int, i: int):
    """Sample i of `seed`: ((n, read_len) R1 codes, R2 codes, planted)."""
    rng = np.random.default_rng([int(seed) % (1 << 64), i])
    L = strain.shape[0]
    n, rl = int(traffic["pairs"]), int(traffic["read_len"])
    f_lo, f_hi = (int(x) for x in traffic["fragment"])
    n_maj, n_min = int(traffic["majors"]), int(traffic["minors"])
    margin, gap, n_sites = int(traffic["site_margin"]), int(traffic["site_gap"]), n_maj + n_min
    # one site in each of n_sites equal bins, `gap` apart at least; which
    # sites are the majors is drawn too
    edges = np.linspace(margin, L - margin, n_sites + 1).astype(np.int64)
    sites = edges[:-1] + rng.integers(0, np.maximum(np.diff(edges) - gap, 1))
    sites = sites[rng.permutation(n_sites)]
    alts = ((strain[sites] + rng.integers(1, 4, sites.shape[0])) % 4).astype(np.uint8)
    lo, hi = (float(x) for x in traffic["minor_af"])
    afs = np.concatenate([np.full(n_maj, float(traffic["major_af"])),
                          lo + (hi - lo) * rng.random(n_min)])

    flen = rng.integers(f_lo, f_hi + 1, n)
    start = (rng.random(n) * (L - flen + 1)).astype(np.int64)
    reverse = rng.random(n) < 0.5
    carry = rng.random((n, sites.shape[0])) < afs[None, :]
    cols = np.arange(rl, dtype=np.int64)
    left = strain[start[:, None] + cols]                   # the fragment's first bases
    right = strain[(start + flen - 1)[:, None] - cols]     # its last, read backwards
    rows = np.arange(n)
    for s, (p, a) in enumerate(zip(sites.tolist(), alts.tolist())):
        off = p - start
        m = carry[:, s] & (off >= 0) & (off < rl)
        left[rows[m], off[m]] = a
        off = start + flen - 1 - p
        m = carry[:, s] & (off >= 0) & (off < rl)
        right[rows[m], off[m]] = a
    right = 3 - right  # the reverse strand's bases
    err = float(traffic["error_rate"])
    for codes in (left, right):
        n_err = int(rng.binomial(codes.size, err))
        at = rng.integers(0, codes.size, n_err)
        flat = codes.reshape(-1)
        flat[at] = (flat[at] + rng.integers(1, 4, n_err)) % 4
    r1 = np.where(reverse[:, None], right, left)
    r2 = np.where(reverse[:, None], left, right)
    planted = [(int(p), int(a), float(f), "major" if j < n_maj else "minor")
               for j, (p, a, f) in enumerate(zip(sites, alts, afs))]
    return r1.astype(np.uint8), r2.astype(np.uint8), planted


def _prune(folder: str, keep: str) -> None:
    """Keep the KEEP_SEEDS most recent sample sets of one mix."""
    sets = sorted((os.path.join(folder, d) for d in os.listdir(folder)
                   if os.path.isdir(os.path.join(folder, d))), key=os.path.getmtime)
    for d in sets[:-KEEP_SEEDS]:
        if d != keep:
            shutil.rmtree(d, ignore_errors=True)


def prepare(config: dict, traffic: dict, seed: int, cache: str, workers: int = 8) -> Inputs:
    """The cell's strains and samples, from the cache or made now."""
    cfg_key = {k: v for k, v in config.items() if k in (
        "genome_len", "strains", "snps_per_strain", "base_strain", "config_seed")}
    folder = os.path.join(cache, f"{config['name']}-{digest(cfg_key)}")
    gdir = os.path.join(folder, "genomes")
    os.makedirs(gdir, exist_ok=True)
    codes = strain_codes(config)
    names = strain_names(config)
    strains = []
    for name, c in zip(names, codes):
        path = os.path.join(gdir, f"{name}.fasta")
        if not os.path.exists(path):
            _atomic_write(path, fasta_bytes(name, c))
        strains.append(path)

    mix_key = {k: v for k, v in traffic.items() if k in (
        "samples", "pairs", "read_len", "fragment", "error_rate", "majors", "major_af",
        "minors", "minor_af", "site_margin", "site_gap", "strain_stride")}
    mix = os.path.join(folder, f"{traffic['name']}-{digest(mix_key)}")
    sdir = os.path.join(mix, str(int(seed)))
    os.makedirs(sdir, exist_ok=True)
    meta_path = os.path.join(sdir, "samples.json")
    n_samples, stride = int(traffic["samples"]), int(traffic["strain_stride"])
    if not os.path.exists(meta_path):
        def one(i: int):
            strain = (stride * i) % len(codes)
            r1, r2, planted = make_sample(codes[strain], traffic, seed, i)
            paths = [os.path.join(sdir, f"s{i}_R{m}.fastq.gz") for m in (1, 2)]
            for path, reads, mate in zip(paths, (r1, r2), (1, 2)):
                _atomic_write(path, _gzip(_fastq(reads, mate)))
            return {"index": i, "strain": strain, "r1": os.path.basename(paths[0]),
                    "r2": os.path.basename(paths[1]), "pairs": int(r1.shape[0]),
                    "planted": planted}

        with ThreadPoolExecutor(max_workers=max(1, min(workers, n_samples))) as pool:
            meta = list(pool.map(one, range(n_samples)))
        _atomic_write(meta_path, json.dumps(meta).encode())
    with open(meta_path) as fh:
        meta = json.load(fh)
    os.utime(sdir)
    _prune(mix, sdir)
    samples = [Sample(m["index"], m["strain"], os.path.join(sdir, m["r1"]),
                      os.path.join(sdir, m["r2"]), m["pairs"],
                      [tuple(p) for p in m["planted"]]) for m in meta]
    return Inputs(strains, names, codes, samples, folder)
