"""Each metric of BENCHMARK.json is read by name, from its own file, out of
a canned record; a reader with nothing to read returns None."""

from __future__ import annotations

import os

import pytest
from conftest import ROOT

from portbench import harness

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
ALL = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
WORK = {"kmers": 150_000, "queries": 2_400_000, "hit_queries": 1_900_000,
        "rows_touched": 480_000, "flat_lanes": 7_400_000, "best_queries": 1_900_000,
        "best_lanes": 1_900_000, "pileup_cells": 120_000}
SECONDS = {"count": 0.5, "h2d": 0.0, "pass1": 0.002, "pass2": 0.003, "d2h": 0.001, "call": 0.15}


def canned(traced: bool = True) -> dict:
    calls = []
    for c in range(10):
        calls.append({"t0": 10.0 + c, "t1": 10.8 + c + 0.01 * c, "wall_s": 0.8 + 0.01 * c,
                      "samples": [{"id": c % 8, "ok": True, "reads": 300_000,
                                   "seconds": dict(SECONDS), "path": ["hist", "streamed"],
                                   "traced": traced and 1 <= c <= 2}]})
    kernels = {"bucket_queries_kernel(unsigned long const*, long)": [4, 40e-6],
               "void probe_tally_kernel<4>(long const*)": [4, 240e-6],
               "fold_table_kernel(unsigned long const*)": [4, 20e-6],
               "walk_scatter_kernel(int const*, int)": [4, 100e-6],
               "void at::native::vectorized_elementwise_kernel<4>(int)": [20, 30e-6]}
    return {"calls": calls, "setup_s": 12.5, "index_setup_s": 0.02,
            "trace": {"window_s": 1.6, "busy_s": 0.004, "kernels": kernels,
                      "device_ops": [["probe_tally_kernel", 240e-6]],
                      "idle_gaps": [["host", 0.5]]},
            "work": {i: dict(WORK) for i in range(8)}, "index": {"k": 21, "J": 16, "G": 4}}


@pytest.mark.parametrize("name", ALL)
def test_every_metric_reads_a_number(name):
    v = harness.reader(name)(canned())
    assert isinstance(v, float) and v > 0


@pytest.mark.parametrize("name", ALL)
def test_nothing_to_read_gives_none(name):
    rec = canned(traced=False)
    rec.update(trace=None, calls=[])
    if name in ("setup_s", "index_setup_s"):
        assert harness.reader(name)(rec) == rec[name]
    else:
        assert harness.reader(name)(rec) is None


def test_values():
    rec = canned()
    read = {n: harness.reader(n)(rec) for n in ALL}
    span = rec["calls"][-1]["t1"] - rec["calls"][0]["t0"]
    assert read["reads_per_s"] == pytest.approx(10 * 300_000 / span)
    # walls 0.80 ... 0.89 s: the 90th percentile lies nine tenths of the way up
    assert read["sample_p90_s"] == pytest.approx(0.881)
    assert read["count_s"] == pytest.approx(0.5) and read["call_s"] == pytest.approx(0.15)
    assert read["map_wall_ms"] == pytest.approx(6.0)
    assert read["map_device_ms"] == pytest.approx(1e3 * 430e-6 / 2)
    assert read["device_idle_pct"] == pytest.approx(100 * (1 - 0.004 / 1.6))
    assert read["setup_s"] == 12.5 and read["index_setup_s"] == 0.02


def test_failed_samples_do_not_count():
    rec = canned()
    rec["calls"][0]["samples"][0]["ok"] = False
    span = rec["calls"][-1]["t1"] - rec["calls"][0]["t0"]
    assert harness.reader("reads_per_s")(rec) == pytest.approx(9 * 300_000 / span)


def test_cell_metrics_follow_workloads():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    single = [m["name"] for m in harness.cell_metrics(BENCH, cells["sars2-4ref.single"], False)]
    cohort = [m["name"] for m in harness.cell_metrics(BENCH, cells["sars2-panel300.cohort"], False)]
    assert single == ["reads_per_s", "sample_p90_s", "setup_s"]
    assert cohort == ["reads_per_s", "setup_s"]
    assert [m["name"] for m in harness.cell_metrics(BENCH, cells["sars2-4ref.single"], True)] \
        == [m["name"] for m in BENCH["per_layer"]]
