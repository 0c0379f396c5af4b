"""The roofline reckoning: kernel names, bytes a sample needs, the share at
or under 100% on canned launches, and a run that fails above it."""

from __future__ import annotations

import pytest
from test_portbench_metrics import WORK, canned

from portbench import harness, roofline


@pytest.mark.parametrize("name, kernel", [
    ("bucket_queries_kernel(unsigned long const*, long, unsigned int, int)", "bucket_queries"),
    ("void walk_hits_kernel<int>(int const*, int const*, long)", "walk_hits"),
    ("void probe_tally_words_kernel(long const*, int const*)", "probe_tally"),
    ("walk_scatter_kernel(int const*, int, int)", "walk_scatter"),
    ("fold_table_kernel(unsigned long const*, int const*, long, int, int*)", "fold_table"),
    ("pack_windows_kernel(unsigned char const*)", None),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None),
])
def test_kernel_of(name, kernel):
    assert roofline.kernel_of(name) == kernel


@pytest.mark.parametrize("path", [("hist", "streamed"), ("hist", "fused"), ("flat", "subindex")])
def test_bytes_by_path(path):
    b = roofline.sample_bytes(WORK, path, 21, 16, 300)
    assert all(v > 0 for v in b.values())
    want = {"bucket_queries", "fold_table", "walk_scatter"}
    assert set(b) == want | ({"walk_hits"} if path[0] == "flat" else {"probe_tally"})
    if path[0] == "flat":  # K1 twice: pass 1, and pass 2 through the sub-index
        assert b["bucket_queries"] == 2 * roofline.sample_bytes(WORK, ("hist", "x"), 21, 16,
                                                                300)["bucket_queries"]


def test_share_at_the_least_time_is_100():
    samples = [(WORK, ("flat", "subindex"))] * 3
    need = {}
    for w, p in samples:
        for k, v in roofline.sample_bytes(w, p, 21, 16, 300).items():
            need[k] = need.get(k, 0) + v
    exact = {k: v / roofline.PEAK_BYTES_PER_S for k, v in need.items()}
    pct, detail = roofline.share(samples, exact, 21, 16, 300)
    assert pct == pytest.approx(100.0)
    slower = {k: 4 * v for k, v in exact.items()}
    assert roofline.share(samples, slower, 21, 16, 300)[0] == pytest.approx(25.0)
    # a kernel that did not run is not counted either way
    part = {k: v for k, v in slower.items() if k != "walk_hits"}
    assert roofline.share(samples, part, 21, 16, 300)[0] == pytest.approx(25.0)
    assert roofline.share(samples, {}, 21, 16, 300)[0] is None


def test_canned_trace_is_under_100():
    v = harness.reader("map_roofline")(canned())
    assert 0 < v <= 100


def test_over_100_fails_the_run():
    rec = canned()
    rec["trace"]["kernels"] = {n: [c, s / 1000] for n, (c, s) in rec["trace"]["kernels"].items()}
    with pytest.raises(roofline.OverRoofline):
        harness.reader("map_roofline")(rec)
