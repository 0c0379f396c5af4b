"""BENCHMARK.json in its required form, and the last line's
schema."""

from __future__ import annotations

import json
import os
import re

import pytest
from conftest import ROOT
from test_portbench_metrics import canned

from portbench import checks, harness

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_seconds_fits_a_full_check():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used and c["file"] not in files
        files.add(c["file"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = harness.load_json(os.path.join(ROOT, c["file"]))
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"] == []
        assert data["guarantees"] and data["assumed"]


def test_workloads():
    names = set()
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1 and w["name"] not in names
        assert (w["config"], w["traffic"]) not in pairs
        names.add(w["name"])
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
    assert names == {"sars2-4ref.single", "sars2-panel300.cohort"}


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    seen = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"reads_per_s", "sample_p90_s", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", f"{m['name']}.py"))
        seen.add(m["name"])
    roof = [m for m in BENCH["per_layer"] if m["name"].endswith("_roofline")]
    assert roof and all(m["unit"] == "%" for m in roof)
    for cell in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        rep = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in rep and len(rep) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    rec = canned()
    rec.update(memory_peak_bytes=123, checks={n: {"value": 0, "limit": 0} for n in checks.NAMES})
    cell = BENCH["workloads"][0]
    line = harness.result_line(rec, harness.cell_metrics(BENCH, cell, traced), traced,
                               "NVIDIA H100 80GB HBM3", 1)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert line["correct"] is True and line["attempted"] == 10 and line["failed"] == 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] == 123
    if traced:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"}
    json.dumps(line)
    rec["checks"]["pileup"]["value"] = 1
    assert harness.result_line(rec, [], traced, "x", 1)["correct"] is False
