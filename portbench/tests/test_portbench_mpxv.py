"""The mpox panel configuration and its traffic mix, read as the harness
reads them, its cell's metrics, and the readers of the caller's three
spans."""

from __future__ import annotations

import os

import pytest
from conftest import ROOT
from test_portbench_metrics import canned

from portbench import harness

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = ("sars2-4ref.single", "sars2-panel300.cohort", "mpxv-16ref.single400k")
CALLER = {"noise_s": "noise", "variants_s": "variants", "write_s": "write"}


def test_mpxv_cell_loads():
    cell, config, traffic = harness.load_cell(BENCH, "mpxv-16ref.single400k")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("mpxv-16ref", "single400k", 1)
    assert (config["genome_len"], config["strains"], config["snps_per_strain"],
            config["base_strain"], config["k"], config["index"]) == (197_209, 16, 400, 0, 21, "db")
    assert config["call_args"] == ["-t", "4", "--counter", "auto"]
    assert config["reduced"] == [] and len(config["source"]) <= 200
    assert set(config["assumed"]) >= {"sequences", "snps_per_strain", "repeats", "strains"}
    single = harness.load_json(os.path.join(ROOT, "portbench", "traffic", "single.json"))
    assert set(traffic) - {"name"} == set(single)
    assert (traffic["samples"], traffic["pairs"], traffic["read_len"], traffic["fragment"],
            traffic["error_rate"]) == (8, 400_000, 150, [300, 500], 0.003)
    assert [(traffic["strain_stride"] * i) % config["strains"] for i in range(8)] \
        == [0, 5, 10, 15, 4, 9, 14, 3]
    assert (traffic["per_call"], traffic["copies"], traffic["warm"], traffic["trace_calls"]) \
        == (1, 1, [[0]], 4)
    assert traffic["env"] == {"BRONKO_PARALLEL_GZ": "0"}
    conf = next(c for c in BENCH["configs"] if c["name"] == "mpxv-16ref")
    assert conf["source"] == config["source"] and conf["reduced"] == []


def test_mpxv_cell_reports_its_metrics():
    w = next(w for w in BENCH["workloads"] if w["name"] == "mpxv-16ref.single400k")
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, w, False)]
    per_layer = {m["name"] for m in harness.cell_metrics(BENCH, w, True)}
    assert {"setup_s", "reads_per_s", "sample_p90_s"} <= set(e2e)
    assert set(CALLER) | {"count_s", "call_s", "map_roofline", "device_idle_pct",
                          "stream_dispatch_ms"} <= per_layer
    assert "count_wait_s" not in per_layer


@pytest.mark.parametrize("name", list(CALLER))
def test_caller_readers(name):
    m = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "s", "lower", "program_span", "host caller", "reads_per_s")
    assert tuple(m["workloads"]) == CELLS
    rec = canned()
    for c in rec["calls"]:
        for s in c["samples"]:
            s["seconds"][CALLER[name]] = 0.05
    assert harness.reader(name)(rec) == pytest.approx(0.05)
    # a program without the span: no sample has the key
    assert harness.reader(name)(canned()) is None
    assert harness.reader(name)({"calls": []}) is None
