"""The Chrome trace reduction: the window span, the busy union, kernels by
name, idle gaps labelled by the host op around them."""

from __future__ import annotations

import json

import pytest

from portbench import trace


def _x(name, cat, ts, dur, **kw):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1, **kw}


EVENTS = [
    _x(trace.WINDOW_SPAN, "user_annotation", 1000.0, 1000.0),
    _x("aten::copy_", "cpu_op", 1050.0, 100.0),
    _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1100.0, 50.0),
    _x("void walk_hits_kernel<int>(int const*)", "kernel", 1140.0, 60.0),  # overlaps the copy
    _x("bucket_queries_kernel(unsigned long const*)", "kernel", 1500.0, 100.0),
    _x("bucket_queries_kernel(unsigned long const*)", "kernel", 1900.0, 200.0),  # past the end
    _x("fold_table_kernel(int)", "kernel", 500.0, 100.0),  # before the window
    _x("aten::sort", "cpu_op", 1600.0, 250.0),
]


def test_reduce():
    r = trace.reduce_events(EVENTS)
    assert r["window_s"] == pytest.approx(1e-3)
    # union: [1100, 1200) + [1500, 1600) + [1900, 2000) = 300 us
    assert r["busy_s"] == pytest.approx(300e-6)
    assert r["kernels"]["bucket_queries_kernel(unsigned long const*)"] == [2, pytest.approx(200e-6)]
    assert "fold_table_kernel(int)" not in r["kernels"]
    ops = dict(r["device_ops"])
    assert ops["bucket_queries_kernel"] == pytest.approx(200e-6)
    assert ops["Memcpy HtoD"] == pytest.approx(50e-6)
    assert ops["walk_hits_kernel"] == pytest.approx(60e-6)
    gaps = r["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 300e-6, 100e-6])
    assert sorted(g[0] for g in gaps) == ["aten::copy_", "aten::sort", "host"]


def test_without_window_span():
    assert trace.reduce_events([e for e in EVENTS if e["cat"] != "user_annotation"]) is None


def test_reduce_file(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    assert trace.reduce_file(str(p)) == trace.reduce_events(EVENTS)


@pytest.mark.parametrize("name, short", [
    ("void at::native::(anonymous namespace)::fill_kernel<int>(int*)", "fill_kernel"),
    ("probe_tally_kernel(long const*, int const*, long, int)", "probe_tally_kernel"),
    ("Memset (Device)", "Memset"),
])
def test_short_name(name, short):
    assert trace.short_name(name) == short
