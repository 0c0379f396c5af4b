"""The benchmark's plain reference: one bronko `call` of a sample, worked out
again from the FASTA and FASTQ files alone.

It imports nothing of the program: counting and mapping are written here
from bronko's semantics (mapper.py), the caller and writers are frozen
copies of the port's host code (noise.py, variants.py, outputs.py). It
runs on any torch device; the benchmark runs it on the card once the
measured window has closed and the program's state is freed.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference import mapper
from portbench.reference.noise import baseline_noise
from portbench.reference.outputs import overview_fields, vcf_text
from portbench.reference.reads import read_codes
from portbench.reference.variants import Stats, call_variants

# bronko call's defaults (upstream consts.rs:2-21, call.rs:1173); a
# configuration's "reference_params" override them where its flags do
DEFAULTS = {
    "ci": 3, "cs": 1_000_000, "n_fixed": 2, "use_full_kmer": False, "min_af": 0.03,
    "no_end_filter": False, "no_strand_filter": False, "no_strand_balance_filter": False,
    "strand_balance_ratio": 0.1, "n_per_strand": 2, "strand_odds_max": 6.0,
    "min_depth": 300, "min_variant_depth": 3, "noise_multiplier": 1.5,
}


@dataclass
class Result:
    reads: int
    unique_counted: int
    tallies: np.ndarray     # (G, 3) int64 perfect / variant / unique
    best: int
    pileup: np.ndarray      # (4, L+1, 4) int32, the selected genome's
    records: list
    overview: tuple         # the overview row after its filename
    stats: Stats
    work: dict = field(default_factory=dict)  # what pass 1 and pass 2 touch


class Reference:
    """The reference over one configuration's strains (2-bit codes and
    names, each strain one sequence named as its file)."""

    def __init__(self, strains: list[np.ndarray], names: list[str], k: int,
                 params: dict | None = None, device: torch.device | None = None):
        self.strains, self.names, self.k = strains, names, k
        self.p = {**DEFAULTS, **(params or {})}
        self.device = device or torch.device("cpu")
        self.pos = mapper.positions(k, self.p["n_fixed"], self.p["use_full_kmer"])
        self._all = None
        self._one: dict[int, mapper.Postings] = {}

    def postings(self, g: int | None = None) -> mapper.Postings:
        if g is None:
            if self._all is None:
                self._all = mapper.build_postings(self.strains, self.k, self.pos, self.device)
            return self._all
        if g not in self._one:
            self._one[g] = mapper.build_postings(self.strains, self.k, self.pos, self.device,
                                                 only=g)
        return self._one[g]

    def run_many(self, samples: list[list[str]], ftype=np.float64) -> list[Result]:
        """Each sample (its FASTQ, or the two mates of a pair) worked out,
        every file read ahead on threads; `ftype` is the caller's float."""
        with ThreadPoolExecutor(max_workers=8) as pool:
            futures = [[pool.submit(read_codes, path) for path in paths] for paths in samples]
            read = [[f.result() for f in fs] for fs in futures]
        return [self._run(files, ftype) for files in read]

    def _run(self, files: list[tuple[np.ndarray, np.ndarray]], ftype) -> Result:
        """One sample from its files' (codes, lengths)."""
        p, k = self.p, self.k
        reads, kms, cts = 0, [], []
        for codes, lengths in files:
            reads += codes.shape[0]
            km, ct = mapper.count_kmers(codes, lengths, k, p["ci"], p["cs"], self.device)
            kms.append(km)
            cts.append(ct)
        kmers, counts = torch.cat(kms), torch.cat(cts)
        canon, is_rc = mapper.canonical(kmers, k)
        q = mapper.masked_keys(canon, k, self.pos)
        tallies, work = mapper.tally(self.postings(), q, len(self.strains))
        tallies = tallies.cpu().numpy()
        best = mapper.pick(tallies, [s.shape[0] for s in self.strains])
        if best is None:
            raise RuntimeError("no genome has a positive score")
        L = self.strains[best].shape[0]
        pile, w2 = mapper.pileup(self.postings(best), canon, is_rc, counts, q, k, L)
        work.update(w2)
        pile = pile.cpu().numpy()
        stats = Stats()
        seq = b"ACGT"
        ref_bytes = np.frombuffer(seq, np.uint8)[self.strains[best]].tobytes()
        noise = baseline_noise(pile[0, :L], pile[1, :L])
        records = call_variants(self.names[best], ref_bytes, pile[0, :L], pile[1, :L],
                                pile[2, :L], pile[3, :L], noise[:, 0], k=k, p=p,
                                stats=stats, ftype=ftype)
        n_unique = int(kmers.shape[0])
        n_perfect, n_variant = int(tallies[best, 0]), int(tallies[best, 1])
        overview = overview_fields(self.names[best], stats, n_perfect, n_variant,
                                   n_unique - n_perfect - n_variant)
        return Result(reads, n_unique, tallies, best, pile, records, overview, stats, work)

    def vcf(self, reads_path: str, res: Result) -> str:
        g = res.best
        return vcf_text(reads_path, res.records, [(self.names[g], self.strains[g].shape[0])])
