"""`correct`: what the window's calls produced, held against the plain
reference, every sample of every call, in every layer.

Each number counts samples (or files, or planted sites) that differ; each
is an exact comparison, so each limit is 0:
  missing   samples of the window's calls that returned no result;
  count     reads or kept k-mers differ (the counter);
  tally     the (G, 3) tallies or the selected genome differ (pass 1);
  pileup    the int32 pileup differs in any cell (pass 2);
  calls     the VCF records, every field (floats bit for bit), or the
            overview row differ (the caller);
  files     VCF files, and the last call's overview, not equal to the
            reference's text (the writers);
  majors    planted majors without a PASS record of their own site and
            alternative base.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.reference.outputs import clean_sample_id, overview_fields, overview_text

NAMES = ("missing", "count", "tally", "pileup", "calls", "files", "majors")


def _rec_key(r) -> tuple:
    return (r.seq, r.pos, r.ref_base, r.alt_base, r.fwd_ref, r.rev_ref, r.fwd_alt, r.rev_alt,
            r.depth, repr(float(r.af)), repr(float(r.sor)))


def program_overview(res) -> tuple:
    s = res.summary
    return overview_fields(s.selected_genome, s.stats, s.n_perfect, s.n_variant, s.n_unmapped)


def compare_samples(window: list[dict], refs: dict, majors: dict) -> dict[str, int]:
    """window: every sample slot of the window's calls, {"id", "name",
    "result" (a SampleResult, or None)}; refs: distinct id -> the
    reference's Result; majors: id -> planted majors, (0-based position,
    alt base code).
    Returns the counts of every number but `files`."""
    n = dict.fromkeys(NAMES, 0)
    del n["files"]
    for slot in window:
        res, ref = slot["result"], refs[slot["id"]]
        if res is None:
            n["missing"] += 1
            continue
        s = res.summary
        n["count"] += (res.reads != ref.reads
                       or s.n_perfect + s.n_variant + s.n_unmapped != ref.unique_counted)
        n["tally"] += (res.best != ref.best
                       or not np.array_equal(np.asarray(res.tallies), ref.tallies))
        n["pileup"] += (res.pileup is None or res.pileup.shape != ref.pileup.shape
                        or not np.array_equal(res.pileup, ref.pileup))
        n["calls"] += ([_rec_key(r) for r in res.records] != [_rec_key(r) for r in ref.records]
                       or program_overview(res) != ref.overview)
        passing = {(r.pos - 1, r.alt_base) for r in res.records if r.af >= 0.5}
        n["majors"] += sum(m not in passing for m in majors[slot["id"]])
    return n


def compare_files(window: list[dict], refs: dict, ref_vcf, out_dir: str,
                  last_call: list[dict]) -> int:
    """VCF files of every sample name in the window, and the overview the
    last call wrote, that differ from the reference's text; ref_vcf(name,
    id) gives the reference's VCF of a name."""
    off = 0
    for name, i in {s["name"]: s["id"] for s in window}.items():
        path = os.path.join(out_dir, clean_sample_id(name) + ".vcf")
        off += _read(path) != ref_vcf(name, i)
    rows = [(s["name"], refs[s["id"]].overview) for s in last_call if s["result"] is not None]
    off += _read(os.path.join(out_dir, "bronko_overview.tsv")) != overview_text(rows)
    return off


def compare(window: list[dict], refs: dict, majors: dict, ref_vcf, out_dir: str,
            last_call: list[dict]) -> dict[str, dict]:
    """Every number with its limit, in NAMES' order."""
    n = compare_samples(window, refs, majors)
    n["files"] = compare_files(window, refs, ref_vcf, out_dir, last_call)
    return {k: {"value": n[k], "limit": 0} for k in NAMES}


def _read(path: str) -> str | None:
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return None


def correct(checks: dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
