"""The port's stream gate (call/engine.py::_can_stream) against JAX's, case
by case of tests/test_stream_gate.py: the env overrides, a calibration
that wins, loses, is stale or corrupt, the latency proxy, a probe that
fails, the paths that force classic, and a cohort's streamed first sample
following the calibration. The port reads and writes its own calibration
file only."""

import json
import logging
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bronko_tpu.call.engine as je  # noqa: E402
import bronko_tpu.config as jc  # noqa: E402
import bronko_tpu.io.native as jn  # noqa: E402
import bronko_tpu_torch.call.engine as te  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.io import native  # noqa: E402

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_ENV = ("BRONKO_STREAM", "BRONKO_NO_STREAM", "BRONKO_STREAM_FIRST")


def _dev(**kw):
    return types.SimpleNamespace(**{"hist": object(), "hist_words": None, "fid_grouped": True,
                                    "device": CPU, **kw})


def _patch(monkeypatch, tmp_path, dispatch_s, calib=None, patch_native=True):
    """Both packages: the round trip pinned, the calibration file in tmp
    (a dict is written as this platform's entry, a string as the file's
    text), the native library present unless patch_native is False, no
    stream variable set. Returns the port's and JAX's calibration paths."""
    paths = (str(tmp_path / "torch_calib.json"), str(tmp_path / "jax_calib.json"))
    monkeypatch.setattr(te, "_DISPATCH_LAT", {"cpu": dispatch_s})
    monkeypatch.setattr(je, "_DISPATCH_LAT", [dispatch_s])
    monkeypatch.setattr(te, "_STREAM_CALIB_PATH", paths[0])
    monkeypatch.setattr(je, "_STREAM_CALIB_PATH", paths[1])
    if patch_native:
        monkeypatch.setattr(native, "get_lib", lambda: object())
        monkeypatch.setattr(jn, "get_lib", lambda: object())
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    for var in STREAM_ENV:
        monkeypatch.delenv(var, raising=False)
    if calib is not None:
        for path in paths:
            with open(path, "w") as fh:
                fh.write(calib if isinstance(calib, str) else json.dumps({"cpu": calib}))
    return paths


def _both(tmp_path, cfg_kw=None, dev_kw=None, sharded=None, explicit=False):
    """(JAX's decision, the port's) on the same configuration."""
    cfg_kw = dict(db="x", reads=["r.fastq"], output=str(tmp_path / "o"), **(cfg_kw or {}))
    want = je._can_stream(jc.CallConfig(**cfg_kw), _dev(**(dev_kw or {})), sharded,
                          explicit=explicit)
    got = te._can_stream(CallConfig(**cfg_kw), _dev(**(dev_kw or {})), sharded,
                         explicit=explicit)
    return want, got


def _calib(classic_s, streamed_s, dispatch_s):
    return dict(classic_s=classic_s, streamed_s=streamed_s, dispatch_s=dispatch_s, ts=0)


GATE_CASES = {  # id: (round trip s, calibration, env, decision)
    "calibration_overrides_latency_proxy": (0.035, _calib(0.649, 0.530, 0.035), {}, True),
    "calibration_classic_wins": (0.001, _calib(0.5, 0.7, 0.001), {}, False),
    "stale_calibration_falls_back_to_proxy": (0.035, _calib(0.9, 0.4, 0.001), {}, False),
    "no_calibration_fast_proxy": (0.001, None, {}, True),
    "no_calibration_slow_proxy": (0.035, None, {}, False),
    "no_stream_beats_calibration": (0.035, _calib(0.6, 0.5, 0.035),
                                    {"BRONKO_NO_STREAM": "1"}, False),
    "stream_0_beats_calibration": (0.035, _calib(0.6, 0.5, 0.035), {"BRONKO_STREAM": "0"}, False),
    "stream_1_beats_slow_proxy": (0.035, None, {"BRONKO_STREAM": "1"}, True),
    "stream_1_beats_calibration": (0.001, _calib(0.5, 0.7, 0.001), {"BRONKO_STREAM": "1"}, True),
    "no_stream_off_is_not_a_veto": (0.001, None, {"BRONKO_NO_STREAM": "off"}, True),
    "corrupt_calibration_ignored": (0.035, "{not json", {}, False),
    "entry_without_streamed_ignored": (0.001, {"classic_s": 0.5, "dispatch_s": 0.001}, {}, True),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_decision_equals_jax(monkeypatch, tmp_path, caplog, case):
    """Each case of tests/test_stream_gate.py (and a few more): the port
    decides as JAX does and logs the same gate line."""
    dispatch_s, calib, env, decision = GATE_CASES[case]
    _patch(monkeypatch, tmp_path, dispatch_s, calib)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with caplog.at_level(logging.INFO, logger="bronko"):
        caplog.clear()
        want = je._can_stream(jc.CallConfig(db="x", reads=["r"], output="o"), _dev(), None)
        jax_lines = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = te._can_stream(CallConfig(db="x", reads=["r"], output="o"), _dev(), None)
        port_lines = [r.getMessage() for r in caplog.records]
    assert want is got is decision
    assert port_lines == jax_lines


@pytest.mark.parametrize("case", ["mesh", "device_counter", "keep_kmer_info", "flat",
                                  "ungrouped", "no_native_lib"])
def test_paths_that_force_classic(monkeypatch, tmp_path, case):
    """A mesh, the device counter, --keep-kmer-info, an index without a
    histogram, postings not grouped by genome and a missing native library
    keep a sample classic in both packages, even under BRONKO_STREAM=1 and
    a calibration that says streaming wins; the explicit opt-in of
    BRONKO_STREAM_FIRST=1 does not get past them either."""
    _patch(monkeypatch, tmp_path, 0.001, _calib(0.9, 0.5, 0.001))
    monkeypatch.setenv("BRONKO_STREAM", "1")
    kw = {"mesh": dict(sharded=object()),
          "device_counter": dict(cfg_kw={"counter": "device"}),
          "keep_kmer_info": dict(cfg_kw={"keep_kmer_counts": True}),
          "flat": dict(dev_kw={"hist": None}),
          "ungrouped": dict(dev_kw={"fid_grouped": False}),
          "no_native_lib": {}}[case]
    assert _both(tmp_path) == (True, True)  # streams without the cause
    if case == "no_native_lib":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jn, "get_lib", lambda: None)
    for explicit in (False, True):
        assert _both(tmp_path, explicit=explicit, **kw) == (False, False)


def test_probe_fails_closed(monkeypatch, tmp_path):
    """A round-trip probe that raises reads 1.0 s in both packages, so the
    proxy keeps the sample classic."""
    _patch(monkeypatch, tmp_path, 0.0)
    monkeypatch.setattr(te, "_DISPATCH_LAT", {})
    monkeypatch.setattr(je, "_DISPATCH_LAT", [])

    def broken(*args, **kwargs):
        raise RuntimeError("the device is gone")

    monkeypatch.setattr(te, "_sync", broken)
    monkeypatch.setattr(je.jax, "jit", broken)
    assert te._dispatch_latency_s(CPU) == je._dispatch_latency_s() == 1.0
    assert _both(tmp_path) == (False, False)


def test_probe_times_a_round_trip(monkeypatch):
    """Without a failure the probe reads a real round trip, once per
    device type: the second call returns the first's value."""
    monkeypatch.setattr(te, "_DISPATCH_LAT", {})
    lat = te._dispatch_latency_s(CPU)
    assert 0 < lat < 1.0 and te._dispatch_latency_s(CPU) == lat
    assert list(te._DISPATCH_LAT) == ["cpu"]


def test_save_merges_platforms(monkeypatch, tmp_path):
    """save_stream_calibration merges this platform's entry into the file
    (another platform's stays), and the gate consumes it at once."""
    path, _ = _patch(monkeypatch, tmp_path, 0.02)
    with open(path, "w") as fh:
        json.dump({"gpu": _calib(1, 2, 0.001)}, fh)
    entry = te.save_stream_calibration(0.65, 0.53)
    d = json.load(open(path))
    assert d["gpu"] == _calib(1, 2, 0.001)
    assert d["cpu"]["classic_s"] == entry["classic_s"] == 0.65
    assert entry["dispatch_s"] == 0.02 and entry["streamed_s"] == 0.53
    assert te._load_stream_calib() == entry == te._load_stream_calib(CPU)
    assert te._load_stream_calib(torch.device("cuda")) == _calib(1, 2, 0.001)
    assert te._can_stream(CallConfig(db="x", reads=["r"], output="o"), _dev(), None) is True


def test_corrupt_calibration_ignored(monkeypatch, tmp_path):
    path, _ = _patch(monkeypatch, tmp_path, 0.035)
    with open(path, "w") as fh:
        fh.write("{not json")
    assert te._load_stream_calib() is None
    assert te._can_stream(CallConfig(db="x", reads=["r"], output="o"), _dev(), None) is False
    # a calibration file that cannot be written only warns
    monkeypatch.setattr(te, "_STREAM_CALIB_PATH", str(tmp_path / "file" / "sub" / "c.json"))
    (tmp_path / "file").write_text("not a directory")
    assert te.save_stream_calibration(0.5, 0.4)["classic_s"] == 0.5


GATE_SCRIPT = """
import json, logging, sys
import bronko_tpu_torch.call.engine as te
from bronko_tpu_torch.config import CallConfig
from types import SimpleNamespace
import torch
te._DISPATCH_LAT["cpu"] = 0.001
dev = SimpleNamespace(hist=object(), hist_words=None, fid_grouped=True,
                      device=torch.device("cpu"))
print(json.dumps([te._STREAM_CALIB_PATH,
                  te._can_stream(CallConfig(db="x", reads=["r"], output="o"), dev, None)]))
"""


def test_jax_calibration_file_leaves_the_port_unchanged(tmp_path):
    """Under a home directory whose JAX calibration says classic wins, the
    port (its calibration path taken from that home) streams on the proxy;
    its own file under the same home says classic wins, and then it
    decides classic."""
    home = tmp_path / "home"
    jax_dir, port_dir = home / ".cache" / "bronko_jax", home / ".cache" / "bronko_torch"
    jax_dir.mkdir(parents=True)
    classic_wins = json.dumps({"cpu": _calib(0.5, 0.9, 0.001)})
    (jax_dir / "stream_calib.json").write_text(classic_wins)
    env = {k: v for k, v in os.environ.items() if k not in STREAM_ENV}
    env.update(HOME=str(home), BRONKO_PLATFORM="cpu", PYTHONPATH=REPO)

    def decide():
        out = subprocess.run([sys.executable, "-c", GATE_SCRIPT], env=env, cwd=REPO,
                             capture_output=True, text=True, check=True, timeout=300)
        return json.loads(out.stdout.strip().splitlines()[-1])

    path, decision = decide()
    assert path == str(port_dir / "stream_calib.json") and decision is True
    port_dir.mkdir(parents=True)
    (port_dir / "stream_calib.json").write_text(classic_wins)
    assert decide() == [path, False]


def test_cohort_stream_first_follows_calibration(monkeypatch, tmp_path, caplog):
    """With BRONKO_STREAM_FIRST unset, a cohort's first sample streams when
    the calibration says streaming wins and stays classic when it loses;
    BRONKO_STREAM_FIRST=0 beats the calibration, =1 beats a calibration
    that loses. The files are the same every time."""
    from bronko_tpu_torch.index.build import build_index
    from bronko_tpu_torch.index.layout import build_device_index
    from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq

    rng = np.random.default_rng(13)
    seq = make_genome(rng, 600)
    fasta = str(tmp_path / "g.fasta")
    write_fasta(fasta, "gseq", seq)
    fqs = []
    for s in range(2):
        reads, _ = make_sample(seq, rng, read_len=100, depth=120,
                               major_positions={150 + 30 * s: 0.9},
                               minor_positions={}, error_rate=0.003)
        fqs.append(str(tmp_path / f"s{s}.fastq.gz"))
        write_fastq(fqs[-1], reads)
    index = build_index(21, [fasta])
    dev = build_device_index(index, CPU)

    def run(tag, calib, **env):
        (tmp_path / tag).mkdir()
        _patch(monkeypatch, tmp_path / tag, 0.001, calib, patch_native=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        out = str(tmp_path / f"out_{tag}")
        with caplog.at_level(logging.INFO, logger="bronko"):
            caplog.clear()
            results = te.run_call(CallConfig(genomes=[fasta], reads=list(fqs), output=out,
                                             batch_size=1024, chunk_reads=4096), index, dev)
        logged = any(r.getMessage().endswith("(streamed)") for r in caplog.records)
        assert logged == (results[0].path[1] == "streamed")
        assert [r.path[1] for r in results[1:]] == ["fused"]
        files = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
        return logged, files

    wins, loses = _calib(0.9, 0.5, 0.001), _calib(0.5, 0.9, 0.001)
    on, files_on = run("auto_on", wins)
    off, files_off = run("auto_off", loses)
    forced_off, files_f0 = run("forced_off", wins, BRONKO_STREAM_FIRST="0")
    forced_on, files_f1 = run("forced_on", loses, BRONKO_STREAM_FIRST="1")
    assert (on, off, forced_off, forced_on) == (True, False, False, True)
    assert files_on == files_off == files_f0 == files_f1 and len(files_on) == 3
