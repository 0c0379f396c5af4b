"""The port's stream gate (call/engine.py::_can_stream) case by case of
tests/test_stream_gate.py, beside JAX's: the port streams every sample
that nothing keeps classic, and neither a device round trip nor a
calibration file moves it; the env overrides and the paths that force
classic decide as in JAX; a cohort's first sample follows
BRONKO_STREAM_FIRST, else the gate."""

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
    """JAX's round trip pinned and its calibration file in tmp (a dict is
    written as this platform's entry, a string as the file's text); the
    native library present in both packages unless patch_native is
    False; no stream variable set."""
    path = str(tmp_path / "jax_calib.json")
    monkeypatch.setattr(je, "_DISPATCH_LAT", [dispatch_s])
    monkeypatch.setattr(je, "_STREAM_CALIB_PATH", path)
    if patch_native:
        monkeypatch.setattr(native, "get_lib", lambda: object())
        monkeypatch.setattr(jn, "get_lib", lambda: object())
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    for var in STREAM_ENV:
        monkeypatch.delenv(var, raising=False)
    if calib is not None:
        with open(path, "w") as fh:
            fh.write(calib if isinstance(calib, str) else json.dumps({"cpu": calib}))


def _both(tmp_path, cfg_kw=None, dev_kw=None, sharded=None, explicit=False):
    """(JAX's decision, the port's) on the same configuration; `explicit`
    is JAX's opt-in of BRONKO_STREAM_FIRST=1, which the port's gate does
    not take."""
    cfg_kw = dict(db="x", reads=["r.fastq"], output=str(tmp_path / "o"), **(cfg_kw or {}))
    want = je._can_stream(jc.CallConfig(**cfg_kw), _dev(**(dev_kw or {})), sharded,
                          explicit=explicit)
    got = te._can_stream(CallConfig(**cfg_kw), _dev(**(dev_kw or {})), sharded)
    return want, got


def _calib(classic_s, streamed_s, dispatch_s):
    return dict(classic_s=classic_s, streamed_s=streamed_s, dispatch_s=dispatch_s, ts=0)


GATE_CASES = {  # id: (JAX's round trip s, JAX's calibration, env, JAX's decision, the port's)
    "calibration_overrides_latency_proxy": (0.035, _calib(0.649, 0.530, 0.035), {}, True, True),
    "calibration_classic_wins": (0.001, _calib(0.5, 0.7, 0.001), {}, False, True),
    "stale_calibration_falls_back_to_proxy": (0.035, _calib(0.9, 0.4, 0.001), {}, False, True),
    "no_calibration_fast_proxy": (0.001, None, {}, True, True),
    "no_calibration_slow_proxy": (0.035, None, {}, False, True),
    "no_stream_beats_calibration": (0.035, _calib(0.6, 0.5, 0.035),
                                    {"BRONKO_NO_STREAM": "1"}, False, False),
    "stream_0_beats_calibration": (0.035, _calib(0.6, 0.5, 0.035), {"BRONKO_STREAM": "0"},
                                   False, False),
    "stream_1_beats_slow_proxy": (0.035, None, {"BRONKO_STREAM": "1"}, True, True),
    "stream_1_beats_calibration": (0.001, _calib(0.5, 0.7, 0.001), {"BRONKO_STREAM": "1"},
                                   True, True),
    "no_stream_off_is_not_a_veto": (0.001, None, {"BRONKO_NO_STREAM": "off"}, True, True),
    "corrupt_calibration_ignored": (0.035, "{not json", {}, False, True),
    "entry_without_streamed_ignored": (0.001, {"classic_s": 0.5, "dispatch_s": 0.001}, {},
                                       True, True),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_decision_equals_jax(monkeypatch, tmp_path, case):
    """Each case of tests/test_stream_gate.py (and a few more), JAX's
    decision and the port's: they agree where JAX decides by the
    environment; where JAX's round trip or calibration decides, the port
    streams all the same."""
    dispatch_s, calib, env, jax_decision, decision = GATE_CASES[case]
    _patch(monkeypatch, tmp_path, dispatch_s, calib)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _both(tmp_path) == (jax_decision, decision)


@pytest.mark.parametrize("case", ["mesh", "device_counter", "keep_kmer_info", "flat",
                                  "ungrouped", "no_native_lib"])
def test_paths_that_force_classic(monkeypatch, tmp_path, case):
    """A mesh, the device counter, --keep-kmer-info, an index without a
    histogram, postings not grouped by genome and a missing native library
    keep a sample classic in both packages, even under BRONKO_STREAM=1 and
    a calibration that says streaming wins; BRONKO_STREAM_FIRST=1 (JAX's
    explicit opt-in) does not get past them either."""
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
    monkeypatch.setenv("BRONKO_STREAM_FIRST", "1")
    cfg = CallConfig(db="x", reads=["a.fastq", "b.fastq"], output=str(tmp_path / "o"),
                     **kw.get("cfg_kw", {}))
    assert te._streams_first(cfg, _dev(**kw.get("dev_kw", {})), kw.get("sharded"), 2) is False


GATE_SCRIPT = """
import json
from types import SimpleNamespace
import torch
import bronko_tpu_torch.call.engine as te
from bronko_tpu_torch.config import CallConfig
dev = SimpleNamespace(hist=object(), hist_words=None, fid_grouped=True,
                      device=torch.device("cpu"))
decision = te._can_stream(CallConfig(db="x", reads=["r"], output="o"), dev, None)
if "--jax" in __import__("sys").argv:
    import bronko_tpu.call.engine as je
    import bronko_tpu.config as jc
    je._DISPATCH_LAT.append(0.001)
    decision = [decision, je._can_stream(jc.CallConfig(db="x", reads=["r"], output="o"),
                                         dev, None)]
print(json.dumps(decision))
"""


def _decide(home, jax=False):
    """The gate's decision in a fresh process under `home`, with no stream
    variable set (with jax, [the port's, JAX's with its round trip pinned
    at 1 ms])."""
    env = {k: v for k, v in os.environ.items() if k not in STREAM_ENV}
    env.update(HOME=str(home), BRONKO_PLATFORM="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", GATE_SCRIPT, *(["--jax"] if jax else [])],
                         env=env, cwd=REPO, capture_output=True, text=True, check=True,
                         timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_jax_calibration_file_leaves_the_port_unchanged(tmp_path):
    """Under a home directory whose JAX calibration says classic wins, JAX
    decides classic and the port streams."""
    jax_dir = tmp_path / "home" / ".cache" / "bronko_jax"
    jax_dir.mkdir(parents=True)
    (jax_dir / "stream_calib.json").write_text(json.dumps({"cpu": _calib(0.5, 0.9, 0.001)}))
    assert _decide(tmp_path / "home", jax=True) == [True, False]


@pytest.mark.parametrize("which", ["port_classic_wins", "jax_classic_wins", "corrupt"])
def test_no_calibration_file_moves_the_gate(tmp_path, which):
    """A calibration file under the home directory, where the port once
    read its own (~/.cache/bronko_torch/stream_calib.json) or where JAX
    reads its (~/.cache/bronko_jax/...), saying classic wins on every
    platform, or a corrupt one: a lone sample streams all the same."""
    home = tmp_path / "home"
    folder = home / ".cache" / ("bronko_jax" if which == "jax_classic_wins" else "bronko_torch")
    folder.mkdir(parents=True)
    loses = _calib(0.5, 0.9, 0.001)
    (folder / "stream_calib.json").write_text(
        "{not json" if which == "corrupt" else json.dumps({"cpu": loses, "gpu": loses}))
    assert _decide(home) is True


def test_cohort_stream_first_follows_calibration(monkeypatch, tmp_path, caplog):
    """A cohort's first sample follows BRONKO_STREAM_FIRST, else the gate:
    with the variable unset it streams, and stays classic when
    BRONKO_STREAM=0 keeps the gate off; BRONKO_STREAM_FIRST=0 keeps it
    classic, =1 streams it. The later samples take the saved probe, and
    the files are the same every time."""
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

    def run(tag, **env):
        (tmp_path / tag).mkdir()
        _patch(monkeypatch, tmp_path / tag, 0.001, patch_native=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        out = str(tmp_path / f"out_{tag}")
        with caplog.at_level(logging.INFO, logger="bronko"):
            caplog.clear()
            results = te.run_call(CallConfig(genomes=[fasta], reads=list(fqs), output=out,
                                             batch_size=1024, chunk_reads=4096), index, dev)
        logged = any(r.getMessage().endswith("(streamed)") for r in caplog.records)
        assert logged == (results[0].path[1] == "streamed")
        assert [r.path[1] for r in results[1:]] == ["saved"]
        files = {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}
        return logged, files

    on, files_on = run("auto_on")
    off, files_off = run("auto_off", BRONKO_STREAM="0")
    forced_off, files_f0 = run("forced_off", BRONKO_STREAM_FIRST="0")
    forced_on, files_f1 = run("forced_on", BRONKO_STREAM_FIRST="1")
    assert (on, off, forced_off, forced_on) == (True, False, False, True)
    assert files_on == files_off == files_f0 == files_f1 and len(files_on) == 3
