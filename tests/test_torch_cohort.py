"""The port's cohort pipeline on the CPU against bronko_tpu's run_call on
the same inputs, every output file byte-equal: count workers, the
inflate-ahead worker under its budget, the caller thread, per-sample
isolation; the `--counter auto` fallback; `--profile-dir`; the memory
log lines."""

import gzip
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bronko_tpu.call.engine as jax_engine  # noqa: E402
import bronko_tpu.config as jax_config  # noqa: E402
import bronko_tpu.index.build as jax_build  # noqa: E402
import bronko_tpu.index.layout as jax_layout  # noqa: E402
import bronko_tpu.io.native as jax_native  # noqa: E402
import bronko_tpu_torch.call.engine as engine  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from bronko_tpu_torch.io import native  # noqa: E402
from bronko_tpu_torch.utils import memory  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

CPU = torch.device("cpu")
ENV = ("BRONKO_COUNT_WORKERS", "BRONKO_INFLATE_BUDGET", "BRONKO_NO_STREAM")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """tests/test_engine.py's sample at a third of its depth, and the
    index of its genome in both packages."""
    tmp = tmp_path_factory.mktemp("torch_cohort")
    rng = np.random.default_rng(17)
    genome = make_genome(rng, 1200)
    reads, _ = make_sample(genome, rng, read_len=80, depth=240,
                           major_positions={300: 0.92}, minor_positions={700: 0.15},
                           error_rate=0.004)
    ref, fq = str(tmp / "ref.fasta"), str(tmp / "samp.fastq.gz")
    write_fasta(ref, "sref", genome)
    write_fastq(fq, reads)
    jindex = jax_build.build_index(21, [ref])
    return tmp, ref, fq, jindex


def _outputs(out):
    return {f: open(os.path.join(out, f), "rb").read() for f in sorted(os.listdir(out))}


def _run_both(synth, out, monkeypatch, env=None, **kw):
    """run_call of both packages on the same cohort: (JAX result or the
    SystemExit code, its files), the same for the port."""
    _, ref, _, jindex = synth
    got = {}
    for name in ("jax", "torch"):
        for k in ENV:
            monkeypatch.delenv(k, raising=False)
        for k, v in (env or {}).items():
            monkeypatch.setenv(k, v)
        if name == "jax":
            run, cfg, idx, dev = (jax_engine.run_call, jax_config.CallConfig, jindex,
                                  jax_layout.build_device_index(jindex))
        else:
            index = from_jax_index(jindex)
            run, cfg, idx, dev = engine.run_call, CallConfig, index, build_device_index(index, CPU)
        o = str(out / name)
        try:
            res = run(cfg(genomes=[ref], output=o, batch_size=4096, chunk_reads=8192, **kw),
                      idx, dev)
        except SystemExit as e:
            res = e.code
        got[name] = (res, _outputs(o) if os.path.isdir(o) else {})
    return got["jax"], got["torch"]


def _failure_files(tmp_path, fq):
    missing = str(tmp_path / "missing.fastq.gz")
    truncated = str(tmp_path / "trunc.fastq.gz")
    with open(fq, "rb") as src, open(truncated, "wb") as dst:
        dst.write(src.read()[:200])  # mid-stream cut: corrupt gzip
    malformed = str(tmp_path / "bad.fastq.gz")
    with gzip.open(malformed, "wt") as fh:
        fh.write("this is not\na fastq at all\n")
    empty = str(tmp_path / "empty.fastq.gz")
    with gzip.open(empty, "wt") as fh:
        fh.write("")
    return missing, truncated, malformed, empty


def test_cohort_scale_prefetch_and_isolation(synth, tmp_path, monkeypatch):
    """tests/test_engine.py's 16-sample cohort: a missing, a truncated, a
    malformed and an empty file among 12 copies of one sample, 2 count
    workers and a 64 KB inflate-ahead budget (some files skip the
    prefetch). Every file equals bronko_tpu's; the 12 good samples come
    back in input order."""
    _, _, fq, _ = synth
    good = []
    for i in range(12):
        good.append(str(tmp_path / f"c{i}.fastq.gz"))
        with open(fq, "rb") as src, open(good[-1], "wb") as dst:
            dst.write(src.read())
    missing, truncated, malformed, empty = _failure_files(tmp_path, fq)
    reads = (good[:3] + [missing] + good[3:6] + [truncated] + good[6:9]
             + [malformed] + good[9:] + [empty])
    (jres, jout), (tres, tout) = _run_both(
        synth, tmp_path, monkeypatch,
        env={"BRONKO_COUNT_WORKERS": "2", "BRONKO_INFLATE_BUDGET": str(64 << 10)},
        reads=reads)
    assert len(jres) == len(tres) == len(good)
    assert [r.summary.filename for r in tres] == good
    assert sum(f.endswith(".vcf") for f in tout) == len(good)
    assert tout == jout
    assert len(tout["bronko_overview.tsv"].splitlines()) == 1 + len(good)


@pytest.mark.parametrize("env", [{}, {"BRONKO_INFLATE_BUDGET": "0"},
                                 {"BRONKO_COUNT_WORKERS": "2"},
                                 {"BRONKO_COUNT_WORKERS": "two"}],
                         ids=["default", "nobudget", "workers2", "workers_not_int"])
def test_count_concurrency_paths_byte_identical(synth, tmp_path, monkeypatch, caplog, env):
    """A 3-sample cohort, paired mates included, with the inflate-ahead
    prefetch, with its budget at 0, with 2 count workers and with a
    worker count that is not an integer (a warning, then 1): each equals
    bronko_tpu's files."""
    _, _, fq, _ = synth
    (_, jout), (tres, tout) = _run_both(synth, tmp_path, monkeypatch, env=env,
                                        reads=[fq, fq], first_pairs=[fq], second_pairs=[fq],
                                        output_pileup=True)
    assert len(tres) == 3 and any(f.endswith(".vcf") for f in tout)
    assert tout == jout
    if env.get("BRONKO_COUNT_WORKERS") == "two":
        assert "BRONKO_COUNT_WORKERS is not an integer; using 1" in caplog.text


def test_keep_kmer_info_and_isolation(synth, tmp_path, monkeypatch):
    """A missing file before a good one, with --keep-kmer-info: the good
    sample's outputs and k-mer dump equal bronko_tpu's."""
    _, _, fq, _ = synth
    (jres, jout), (tres, tout) = _run_both(
        synth, tmp_path, monkeypatch, reads=[str(tmp_path / "missing.fastq.gz"), fq],
        keep_kmer_counts=True)
    assert len(jres) == len(tres) == 1
    assert "samp_counts.txt" in tout and tout == jout
    line = tout["samp_counts.txt"].decode().split("\n", 1)[0].split()
    assert len(line[0]) == 21 and int(line[1]) >= 2


@pytest.mark.parametrize("error", [OSError, ValueError])
@pytest.mark.parametrize("counter", ["auto", "host"])
def test_native_counter_failure_follows_jax(synth, tmp_path, monkeypatch, error, counter):
    """Any exception from the native counter: under auto both packages
    count on the device instead and write the same bytes; under host both
    raise (the sample fails, and with it the run)."""
    def broken(*args, **kwargs):
        raise error("the native counter rejects this file")

    _, _, fq, _ = synth
    monkeypatch.setattr(native, "native_count_fastq", broken)
    monkeypatch.setattr(jax_native, "native_count_fastq", broken)
    cfg_kw = dict(genomes=[synth[1]], counter=counter, chunk_reads=8192)
    for count_sample, cfg in ((engine.count_sample, CallConfig(**cfg_kw)),
                              (jax_engine.count_sample, jax_config.CallConfig(**cfg_kw))):
        args = (fq, cfg, 21, CPU) if count_sample is engine.count_sample else (fq, cfg, 21)
        if counter == "host":
            with pytest.raises(error):
                count_sample(*args)
        else:
            assert count_sample(*args)[2].total_reads > 0
    # the JAX engine's single-sample stream path has its own counter
    (jres, jout), (tres, tout) = _run_both(synth, tmp_path, monkeypatch,
                                           env={"BRONKO_NO_STREAM": "1"},
                                           reads=[fq], counter=counter)
    if counter == "host":
        assert jres == tres == 1
    else:
        assert len(jres) == len(tres) == 1 and "samp.vcf" in tout and tout == jout


class _FailingProfile:
    def __init__(self, **kwargs):
        pass

    def start(self):
        pass

    def stop(self):
        raise RuntimeError("the trace could not be collected")


@pytest.mark.parametrize("case", ["trace", "start_fails", "stop_fails"])
def test_profile_dir(synth, tmp_path, monkeypatch, caplog, case):
    """--profile-dir writes a torch.profiler Chrome trace and leaves the
    outputs as they are; a profiler that fails to start or stop only
    warns."""
    _, ref, fq, jindex = synth
    index = from_jax_index(jindex)
    if case == "start_fails":
        def refuse(**kwargs):
            raise RuntimeError("no profiler here")
        monkeypatch.setattr(torch.profiler, "profile", refuse)
    elif case == "stop_fails":
        monkeypatch.setattr(torch.profiler, "profile", _FailingProfile)
    outs = {}
    for name, prof in (("plain", None), ("profiled", str(tmp_path / "prof"))):
        cfg = CallConfig(genomes=[ref], reads=[fq], output=str(tmp_path / name),
                         profile_dir=prof, batch_size=4096, output_pileup=True)
        (res,) = engine.run_call(cfg, index, build_device_index(index, CPU))
        outs[name] = _outputs(cfg.output)
    assert outs["plain"] == outs["profiled"] and "samp.tsv" in outs["plain"]
    traces = os.listdir(tmp_path / "prof") if os.path.isdir(tmp_path / "prof") else []
    if case == "trace":
        assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
        assert '"traceEvents"' in open(tmp_path / "prof" / traces[0]).read()
    else:
        assert traces == []
        want = {"start_fails": "profiler unavailable", "stop_fails": "profiler stop failed"}
        assert want[case] in caplog.text


def test_memory_log_lines(synth, tmp_path, monkeypatch, caplog):
    """log_memory_usage logs host RSS where the JAX engine logs it, and the
    device's allocated bytes for a CUDA device."""
    _, ref, fq, jindex = synth
    caplog.set_level(logging.INFO, logger="bronko")
    index = from_jax_index(jindex)
    engine.run_call(CallConfig(genomes=[ref], reads=[fq], output=str(tmp_path / "o"),
                               batch_size=4096), index, build_device_index(index, CPU))
    for msg in ("Finished counting kmers", "Called variants successfully"):
        lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith(msg)]
        assert len(lines) == 1 and " --- Memory usage: host " in lines[0]
        assert "device" not in lines[0]
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda dev: {"allocated_bytes.all.current": 1_234_000_000})
    caplog.clear()
    memory.log_memory_usage("probe", torch.device("cuda", 0))
    assert caplog.records[-1].getMessage().endswith(" GB, device 1.23 GB")


def test_stage_seconds_come_from_their_threads(synth, tmp_path, monkeypatch):
    """Each SampleResult carries every stage's wall time; count and h2d
    are the worker's, call the caller thread's (both above 0), and the
    results come back in input order; process_sample, the same pieces in
    series, gives the same sample."""
    _, ref, fq, jindex = synth
    monkeypatch.setenv("BRONKO_COUNT_WORKERS", "2")
    index = from_jax_index(jindex)
    fqs = [fq, str(tmp_path / "second.fastq.gz")]
    with open(fq, "rb") as src, open(fqs[1], "wb") as dst:
        dst.write(src.read())
    results = engine.run_call(CallConfig(genomes=[ref], reads=fqs, output=str(tmp_path / "o"),
                                         batch_size=4096), index, build_device_index(index, CPU))
    assert [r.summary.filename for r in results] == fqs
    for r in results:
        assert tuple(r.seconds) == engine.STAGES
        assert r.seconds["count"] > 0 and r.seconds["call"] > 0 and r.seconds["h2d"] > 0
    os.makedirs(tmp_path / "one")
    one = engine.process_sample([fq], index, build_device_index(index, CPU),
                                CallConfig(genomes=[ref], reads=[fq], batch_size=4096,
                                           output=str(tmp_path / "one")))
    assert tuple(one.seconds) == engine.STAGES and one.best == results[0].best
    np.testing.assert_array_equal(one.pileup, results[0].pileup)
    assert one.records == results[0].records
