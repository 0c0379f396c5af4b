"""Fixtures of the benchmark's own tests: tiny versions of both cells, run
on the CPU (the program's plain kernels, BRONKO_PLATFORM=cpu)."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

CELLS = ("sars2-4ref.single", "sars2-panel300.cohort")


def tiny(cell_name: str):
    """(cell, config, traffic) of `cell_name`, cut to a size a test holds:
    the single word on 3 strains of 3 kb, or the flat tally on 260
    strains of 700 bp (buckets of 260 postings)."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, config, traffic = harness.load_cell(bench, cell_name)
    if config["strains"] <= 8:
        config.update(genome_len=3000, strains=3, snps_per_strain=6, base_strain=1)
        traffic.update(pairs=4000, site_margin=200, samples=3, majors=3, minors=3,
                       warm=[[0]], trace_calls=2)
    else:
        config.update(genome_len=700, strains=260, snps_per_strain=2)
        traffic.update(pairs=2000, read_len=100, fragment=[150, 250], site_margin=100,
                       site_gap=20, samples=2, majors=2, minors=1, warm=[[0, 1]],
                       per_call=4, copies=2, trace_calls=1)
    return cell, config, traffic


@pytest.fixture
def cpu_program(monkeypatch):
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    for flag in ("BRONKO_STREAM", "BRONKO_NO_STREAM", "BRONKO_STREAM_FIRST"):
        monkeypatch.delenv(flag, raising=False)


@pytest.fixture
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("portbench-cache"))
