"""The port's stage spans (utils/spans.py) on the CPU: the parts of `count`
and `call` and the main thread's waits in SampleResult.seconds, how they
add up to `count` and `call`, the `bronko.*` ranges in a profiler trace
(every thread under --profile-dir), nothing entered with the profiler off,
the sample's counts (SampleResult.counts and the `map` range's name), the
benchmark's readers of the new keys, and tools/torch_idle_by_span.py on a
trace."""

import json
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bronko_tpu_torch.call.engine as engine  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.utils import spans  # noqa: E402
from portbench import harness  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = ("BRONKO_COUNT_WORKERS", "BRONKO_INFLATE_BUDGET", "BRONKO_NO_STREAM", "BRONKO_STREAM",
       "BRONKO_STREAM_FIRST")
KEYS = engine.STAGES + engine.SPAN_KEYS
# each new metric of BENCHMARK.json: the key it reads and its scale
READERS = {"inflate_s": ("inflate", 1.0), "parse_s": ("parse", 1.0),
           "finalize_s": ("finalize", 1.0), "text_wait_s": ("text_wait", 1.0),
           "stream_dispatch_ms": ("dispatch", 1e3), "count_wait_s": ("count_wait", 1.0),
           "noise_s": ("noise", 1.0), "variants_s": ("variants", 1.0), "write_s": ("write", 1.0)}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 4 kb genome, its index, and three pairs of mates."""
    tmp = tmp_path_factory.mktemp("torch_spans")
    rng = np.random.default_rng(41)
    genome = make_genome(rng, 4000)
    ref = str(tmp / "ref.fasta")
    write_fasta(ref, "sref", genome)
    pairs = []
    for i in range(3):
        reads, _ = make_sample(genome, rng, read_len=100, depth=80,
                               major_positions={900 + 500 * i: 0.9}, error_rate=0.003)
        r1, r2 = str(tmp / f"s{i}_1.fastq.gz"), str(tmp / f"s{i}_2.fastq.gz")
        write_fastq(r1, reads[::2])
        write_fastq(r2, reads[1::2])
        pairs.append((r1, r2))
    index = build_index(21, [ref])
    return tmp, ref, pairs, index, build_device_index(index, CPU)


def _run(synth, out, monkeypatch, n=1, env=None, first=0, **kw):
    _, ref, pairs, index, dev = synth
    pairs = pairs[first:]
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    cfg = CallConfig(genomes=[ref], first_pairs=[a for a, _ in pairs[:n]],
                     second_pairs=[b for _, b in pairs[:n]], output=str(out),
                     batch_size=4096, **kw)
    results = engine.run_call(cfg, index, dev)
    assert len(results) == n
    return results


def _inline(s):
    return s["inflate"] - s["inflate_ahead"]


@pytest.mark.parametrize("n", [1, 3], ids=["paired", "cohort"])
def test_every_key_is_kept(synth, tmp_path, monkeypatch, n):
    """(a) A lone paired sample and a cohort of three: every stage and
    every span key, none negative; the counter's parse and finalize ran."""
    for r in _run(synth, tmp_path / "o", monkeypatch, n,
                  env={"BRONKO_COUNT_WORKERS": "2"} if n > 1 else None):
        assert tuple(r.seconds) == KEYS and min(r.seconds.values()) >= 0
        s = r.seconds
        assert s["parse"] > 0 and s["finalize"] > 0 and s["inflate"] > 0
        assert s["inflate_ahead"] <= s["inflate"]


@pytest.mark.parametrize("path", ["classic", "streamed"])
def test_count_splits_into_its_parts(synth, tmp_path, monkeypatch, path):
    """(b) On the classic path count holds the inline inflate, the wait
    for inflate-ahead text, the parse and the finalize, with little else;
    on the streamed path also every partition's dispatch, which the
    classic path never has. Nothing of the main thread's wait for a
    count falls in a lone sample. The streamed path counts mate 1 while
    its reader thread inflates it (counts["piped"] 1), so every inflate
    ran beside the counting thread; the classic path's mates both come
    from the inflate-ahead worker (piped 0)."""
    env = {"BRONKO_NO_STREAM": "1"} if path == "classic" else {"BRONKO_STREAM": "1"}
    (r,) = _run(synth, tmp_path / "o", monkeypatch, 1, env=env)
    s = r.seconds
    assert r.path[1] == ("streamed" if path == "streamed" else "fused")
    parts = _inline(s) + s["text_wait"] + s["parse"] + s["finalize"] + s["dispatch"]
    assert s["count"] >= parts
    if path == "classic":
        assert s["dispatch"] == 0.0 and s["h2d"] > 0
        # the inflate-ahead worker read both mates
        assert s["inflate_ahead"] == s["inflate"] > 0
        assert r.counts["piped"] == 0
    else:
        assert s["dispatch"] > 0 and s["h2d"] == 0.0
        # mate 1 inflates on the counter's reader thread, mate 2 on the prefetch
        assert s["inflate_ahead"] == s["inflate"] > 0
        assert r.counts["piped"] == 1
    assert s["count"] - parts <= 0.25 * s["count"] + 0.005


def test_call_splits_into_its_parts(synth, tmp_path, monkeypatch):
    """(f) Every sample's call holds the noise scan, the filter cascade and
    the writers, and their sum lies within call; in the median of nine
    calls it is within 5% of call. Each sample is a call of its own: in a
    cohort the caller thread waits for the GIL while the main thread maps
    the next sample, and a wait that falls between two spans belongs to
    neither. The median leaves out a call that the host descheduled
    between two spans."""
    shares = []
    for n in range(9):
        (r,) = _run(synth, tmp_path / f"o{n}", monkeypatch, first=n % 3)
        s = r.seconds
        assert s["noise"] > 0 and s["variants"] > 0 and s["write"] > 0
        assert s["noise"] + s["variants"] + s["write"] <= s["call"]
        shares.append((s["noise"] + s["variants"] + s["write"]) / s["call"])
    assert np.median(shares) >= 0.95


@pytest.mark.parametrize("path", ["classic", "streamed", "serial"])
def test_counts_follow_the_index_and_the_batch_size(synth, tmp_path, monkeypatch, path):
    """(g) SampleResult.counts: the kept k-mer rows mapped (every k-mer the
    counter kept, both mates), the device batches of --batch-size (on the
    streamed path each partition's own, at most one more a partition) and
    the index's histogram words a row (the single word here), and the
    mates counted while they inflated: both of `serial`, process_sample,
    which counts each from its path and whose map uploads the batches
    itself; mate 1 of the streamed path; none of the classic path, whose
    mates come from the inflate-ahead worker."""
    from bronko_tpu_torch.io import native

    _, ref, pairs, index, dev = synth
    if path == "serial":
        cfg = CallConfig(genomes=[ref], first_pairs=[pairs[0][0]], second_pairs=[pairs[0][1]],
                         output=str(tmp_path / "o"), batch_size=4096)
        os.makedirs(cfg.output)
        r = engine.process_sample(list(pairs[0]), index, dev, cfg)
    else:
        env = {"BRONKO_NO_STREAM": "1"} if path == "classic" else {"BRONKO_STREAM": "1"}
        (r,) = _run(synth, tmp_path / "o", monkeypatch, 1, env=env)
    s = r.summary
    rows = r.counts["rows"]
    assert set(r.counts) == {"rows", "batches", "words", "piped"}
    assert r.counts["piped"] == {"serial": 2, "streamed": 1, "classic": 0}[path]
    assert rows == s.n_perfect + s.n_variant + s.n_unmapped > 4096
    least = -(-rows // 4096)
    if path != "streamed":
        assert r.counts["batches"] == least
    else:
        assert least <= r.counts["batches"] <= least + 2 * native.NATIVE_COUNT_PARTS
    assert r.counts["words"] == engine.hist_words(dev) == 1 and dev.hist is not None


def _trace(prof, path):
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def test_spans_reach_the_trace_on_the_main_thread(synth, tmp_path, monkeypatch):
    """(c) Under a CPU torch.profiler run the streamed sample's counter and
    dispatch spans are `user_annotation` ranges on the main thread, inside
    the caller's window range."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("test.window"):
        _run(synth, tmp_path / "o", monkeypatch, 1, env={"BRONKO_STREAM": "1"})
    prof.stop()
    events = _trace(prof, tmp_path / "t.json")
    (w,) = [e for e in events if e.get("name") == "test.window" and e.get("ph") == "X"]
    main = threading.get_native_id()
    for name in ("bronko.count.parse", "bronko.count.finalize", "bronko.stream.dispatch",
                 "bronko.count", "bronko.sample.0"):
        got = [e for e in events if e.get("name") == name and e.get("ph") == "X"]
        assert got, name
        for e in got:
            assert e["cat"] == "user_annotation" and e["tid"] == main
            assert w["ts"] <= e["ts"] and e["ts"] + e["dur"] <= w["ts"] + w["dur"]


@pytest.mark.parametrize("path", ["classic", "streamed"])
def test_map_range_is_named_with_the_counts(synth, tmp_path, monkeypatch, path):
    """(h) Under a profiler the main thread's `map` range carries the
    sample's counts in its name, and the tool folds it into `bronko.map`."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_idle_by_span as tool
    finally:
        sys.path.pop(0)
    env = {"BRONKO_NO_STREAM": "1"} if path == "classic" else {"BRONKO_STREAM": "1"}
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    (r,) = _run(synth, tmp_path / "o", monkeypatch, 1, env=env)
    prof.stop()
    events = _trace(prof, tmp_path / "t.json")
    name = "bronko." + engine.map_range(r.counts)
    assert name == "bronko.map.rows={rows}.batches={batches}.words=1".format(**r.counts)
    got = [e for e in events if e.get("name") == name and e.get("ph") == "X"]
    assert len(got) == 1 and got[0]["tid"] == threading.get_native_id()
    assert tool.fold(name) == "bronko.map"


def test_profiler_off_enters_no_range(synth, tmp_path, monkeypatch):
    """(d) With the profiler off no span enters record_function, and a span
    without seconds is the shared no-op."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not spans.profiling()
    assert spans.span("x") is spans.span("y") is spans.sample_span(3)
    for env in ({"BRONKO_STREAM": "1"}, {"BRONKO_COUNT_WORKERS": "2"}):
        _run(synth, tmp_path / str(len(env)), monkeypatch, 3, env=env)
    seconds = {}
    with spans.span("a", seconds):
        pass
    with spans.span("b", seconds, "a"):
        pass
    assert set(seconds) == {"a"} and seconds["a"] >= 0


def _record(values: list[dict]) -> dict:
    return {"calls": [{"samples": [{"ok": True, "seconds": v} for v in values]},
                      {"samples": [{"ok": False, "seconds": {}}]}]}


@pytest.mark.parametrize("metric", list(READERS))
def test_readers_of_the_new_keys(metric):
    """(e) Each new metric is the mean over the completed samples of its
    key, times its scale: a sample without the key reads 0, failed ones
    are left out, and a record where no sample has the key (a program
    without the span) reads None."""
    key, scale = READERS[metric]
    read = harness.reader(metric)
    got = read(_record([{key: 0.2, "count": 1.0}, {key: 0.4}, {"count": 1.0}]))
    assert got == pytest.approx(scale * 0.6 / 3)
    assert read(_record([{"count": 1.0}])) is None
    assert read({"calls": []}) is None
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    (m,) = [m for m in bench["per_layer"] if m["name"] == metric]
    assert (m["source"], m["better"], m["moves"]) == ("program_span", "lower", "reads_per_s")


def _profiled_cohort(synth, tmp_path, monkeypatch):
    _run(synth, tmp_path / "o", monkeypatch, 3,
         env={"BRONKO_COUNT_WORKERS": "2", "BRONKO_NO_STREAM": "1"},
         profile_dir=str(tmp_path / "prof"))
    (name,) = os.listdir(tmp_path / "prof")
    return str(tmp_path / "prof" / name)


@pytest.mark.parametrize("case", ["all_threads", "main_only"])
def test_profile_dir_traces_every_thread(synth, tmp_path, monkeypatch, caplog, case):
    """--profile-dir records the count workers' and the caller thread's
    ranges beside the main thread's, and the tool finds them: each
    sample's count on a worker, its map on the main thread, its call on
    the caller thread. A torch without the all-threads option records
    the main thread alone, with a warning."""
    caplog.set_level(logging.WARNING, logger="bronko")
    if case == "main_only":
        def refuse(**kwargs):
            raise TypeError("no such option")
        monkeypatch.setattr(torch._C._profiler, "_ExperimentalConfig", refuse)
    trace = _profiled_cohort(synth, tmp_path, monkeypatch)
    main = str(threading.get_native_id())
    out = json.loads(subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_idle_by_span.py"), trace, "--json",
         "--tid", main], capture_output=True, text=True, check=True).stdout)
    assert out["main_tid"] == main
    assert out["threads"][main]["bronko.map"] > 0
    assert out["threads"][main]["bronko.count_wait"] >= 0
    assert out["busy_s"] == 0 and out["idle_s"] == pytest.approx(out["window_s"])
    assert sum(out["idle_by_span"].values()) == pytest.approx(out["idle_s"])
    others = {t: row for t, row in out["threads"].items() if t != main}
    workers = [row for row in others.values() if "bronko.count.parse" in row]
    if case == "all_threads":
        assert "the profiler records the main thread only" not in caplog.text
        assert workers and all("bronko.count" in row for row in workers)
        assert any("bronko.call" in row and "bronko.resolve" in row for row in others.values())
        caller = [row for row in others.values() if "bronko.call" in row]
        for part in ("bronko.call.noise", "bronko.call.variants", "bronko.call.write"):
            assert all(0 < row[part] <= row["bronko.call"] for row in caller), part
        assert any("bronko.count.inflate" in row for row in others.values())
    else:
        assert "the profiler records the main thread only" in caplog.text
        assert others == {} and "bronko.count.parse" not in out["threads"][main]


def test_idle_split_by_the_innermost_range():
    """The tool's split of the card's idle time on a hand-made trace:
    busy 2-3 and 6-7, ranges on the main thread (outer 0-8, inner 1-4 and
    5-6) and a worker's range it ignores for the split."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_idle_by_span as tool
    finally:
        sys.path.pop(0)
    X = "user_annotation"
    events = [
        {"ph": "X", "cat": X, "name": "bronko.sample.0", "pid": 1, "tid": 1, "ts": 0, "dur": 8e6},
        {"ph": "X", "cat": X, "name": "bronko.count", "pid": 1, "tid": 1, "ts": 1e6, "dur": 3e6},
        {"ph": "X", "cat": X, "name": "bronko.map", "pid": 1, "tid": 1, "ts": 5e6, "dur": 1e6},
        {"ph": "X", "cat": X, "name": "bronko.count", "pid": 1, "tid": 2, "ts": 0, "dur": 9e6},
        {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7, "ts": 2e6, "dur": 1e6},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "pid": 0, "tid": 7, "ts": 6e6, "dur": 1e6},
        {"ph": "X", "cat": "cpu_op", "name": "aten::x", "pid": 1, "tid": 1, "ts": 9e6,
         "dur": 1e6},
    ]
    out = tool.reduce(events)
    assert out["main_tid"] == "1" and out["window_s"] == pytest.approx(10)
    assert out["busy_s"] == pytest.approx(2) and out["idle_s"] == pytest.approx(8)
    assert out["idle_by_span"] == pytest.approx(
        {"bronko.sample.*": 3, "bronko.count": 2, "bronko.map": 1, "host": 2})
    assert out["threads"]["2"] == {"bronko.count": pytest.approx(9)}

