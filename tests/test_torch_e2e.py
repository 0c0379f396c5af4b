"""The port end to end on the CPU: its run_call against bronko_tpu's on the
same inputs (every output file byte-equal), the golden sample of
tests/test_golden.py, and the CLI's exit codes."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bronko_tpu.call.engine as jax_engine  # noqa: E402
import bronko_tpu.config as jax_config  # noqa: E402
import bronko_tpu.index.build as jax_build  # noqa: E402
import bronko_tpu.index.layout as jax_layout  # noqa: E402
from bronko_tpu_torch import cli  # noqa: E402
from bronko_tpu_torch.call.engine import run_call  # noqa: E402
from bronko_tpu_torch.config import CallConfig  # noqa: E402
from bronko_tpu_torch.index.build import build_index  # noqa: E402
from bronko_tpu_torch.index.layout import build_device_index  # noqa: E402
from bronko_tpu_torch.index.model import from_jax_index  # noqa: E402
from tests import test_golden  # noqa: E402
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A 2-genome panel (a reference, and a strain of it in two contigs)
    and two samples: one drawn from each genome."""
    tmp = tmp_path_factory.mktemp("torch_e2e")
    rng = np.random.default_rng(23)
    genome = make_genome(rng, 1200)
    strain = bytearray(genome)
    for p in rng.integers(100, 1100, 12):
        strain[p] = b"ACGT"[(b"ACGT".index(strain[p]) + 1) % 4]
    strain = bytes(strain)
    ref = str(tmp / "ref.fasta")
    write_fasta(ref, "sref", genome)
    strain_fa = str(tmp / "strain.fasta")
    with open(strain_fa, "w") as fh:
        fh.write(f">contig1\n{strain[:700].decode()}\n>contig2\n{strain[700:].decode()}\n")
    samples = []
    for i, (src, majors) in enumerate([(genome, {300: 0.92}), (strain, {500: 0.9})]):
        reads, _ = make_sample(src, rng, read_len=80, depth=600, major_positions=majors,
                               minor_positions={800: 0.15}, error_rate=0.004)
        fq = str(tmp / f"samp{i}.fastq.gz")
        write_fastq(fq, reads)
        samples.append(fq)
    return tmp, [ref, strain_fa], samples


def _outputs(out):
    return {f: open(os.path.join(out, f)).read() for f in sorted(os.listdir(out))}


@pytest.mark.parametrize("case", ["single", "paired_pileup", "four_alignment",
                                  "single_device", "paired_device"])
def test_run_call_matches_jax(synth, case):
    """The port against bronko_tpu with the same counter; with
    --counter device also against the port's own host counter."""
    tmp, genomes, (fq0, fq1) = synth
    kw = {
        "single": dict(reads=[fq0]),
        "paired_pileup": dict(first_pairs=[fq1], second_pairs=[fq0], output_pileup=True),
        "four_alignment": dict(reads=[fq0, fq1, fq0], first_pairs=[fq0],
                                second_pairs=[fq0], output_alignment=True),
        "single_device": dict(reads=[fq0], counter="device"),
        "paired_device": dict(first_pairs=[fq1], second_pairs=[fq0], output_pileup=True,
                              counter="device"),
    }[case]
    jindex = jax_build.build_index(21, genomes)
    index = from_jax_index(jindex)
    runs = [("jax", jax_engine.run_call, jax_config.CallConfig, jindex,
             jax_layout.build_device_index(jindex), kw),
            ("torch", run_call, CallConfig, index, build_device_index(index, CPU), kw)]
    if kw.get("counter") == "device":
        runs.append(("torch_host", run_call, CallConfig, index, build_device_index(index, CPU),
                     {**kw, "counter": "host"}))
    outs = {}
    for name, run, config, idx, dev, kwargs in runs:
        cfg = config(genomes=genomes, output=str(tmp / f"{case}_{name}"),
                     batch_size=2048, chunk_reads=4096, **kwargs)
        run(cfg, idx, dev)
        outs[name] = _outputs(cfg.output)
    want = outs["jax"]
    assert any(f.endswith(".vcf") for f in want)
    if case == "four_alignment":
        assert any(f.endswith(".mfa") for f in want)
    for name, got in outs.items():
        assert sorted(got) == sorted(want), name
        for f in want:
            assert got[f] == want[f], (name, f)


def test_device_counter_reads_longer_than_the_native_rows(tmp_path, caplog):
    """Reads of 600 bp exceed the native reader's 512-wide rows: the device
    counter restarts the file on the Python parser and still equals the
    host counter."""
    rng = np.random.default_rng(31)
    genome = make_genome(rng, 1500)
    reads, _ = make_sample(genome, rng, read_len=600, depth=40,
                           major_positions={700: 0.95}, error_rate=0.002)
    ref = str(tmp_path / "long.fasta")
    write_fasta(ref, "long", genome)
    fq = str(tmp_path / "long.fastq.gz")
    write_fastq(fq, reads)
    index = build_index(21, [ref])
    results = {}
    for counter in ("host", "device"):
        cfg = CallConfig(genomes=[ref], reads=[fq], output=str(tmp_path / counter),
                         chunk_reads=32, output_pileup=True, counter=counter)
        (results[counter],) = run_call(cfg, index, build_device_index(index, CPU))
    assert "using Python parser" in caplog.text
    np.testing.assert_array_equal(results["device"].pileup, results["host"].pileup)
    assert _outputs(tmp_path / "device") == _outputs(tmp_path / "host")
    assert any(ln.split("\t")[1] == "701"
               for ln in open(tmp_path / "device" / "long.vcf") if not ln.startswith("#"))


def test_golden_sample(tmp_path, monkeypatch):
    """tests/test_golden.py's own pipeline, with the port's config, index
    builder, engine and layout in place of the JAX package's, reproduces
    tests/golden/."""
    monkeypatch.setattr(jax_config, "CallConfig", CallConfig)
    monkeypatch.setattr(jax_build, "build_index", build_index)
    monkeypatch.setattr(jax_engine, "run_call", run_call)
    monkeypatch.setattr(jax_layout, "build_device_index",
                        lambda index: build_device_index(index, CPU))
    vcf, overview = test_golden._produce(str(tmp_path))
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
    assert vcf == open(os.path.join(golden, "gsample.vcf")).read()
    assert overview == open(os.path.join(golden, "overview.tsv")).read()


def _exit_code(argv) -> int:
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    return exc.value.code


def test_cli_build_and_call_match_jax(synth, monkeypatch):
    tmp, genomes, (fq0, _) = synth
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    db = str(tmp / "cli_db")
    assert cli.main(["build", "-g", *genomes, "-o", db]) == 0
    out = str(tmp / "cli_out")
    assert cli.main(["call", "-d", db + ".bkdb", "-r", fq0, "-o", out]) == 0
    jout = str(tmp / "cli_jax")
    index = jax_build.build_index(21, genomes)
    jax_engine.run_call(jax_config.CallConfig(db=db + ".bkdb", reads=[fq0], output=jout),
                        index, jax_layout.build_device_index(index))
    assert _outputs(out) == _outputs(jout)


@pytest.mark.parametrize("counter,native_ok,used", [
    ("auto", True, "host"), ("auto", False, "device"), ("device", True, "device"),
    ("host", False, None),
])
def test_counter_choice(synth, monkeypatch, caplog, counter, native_ok, used):
    """auto counts on the host when the native library builds and loads, else
    on the device; host never falls back. Every counter gives one output."""
    import bronko_tpu_torch.call.engine as engine

    tmp, genomes, (fq0, _) = synth
    if not native_ok:
        def broken():
            raise RuntimeError("building the native library failed")
        monkeypatch.setattr(engine, "native_lib", broken)
    caplog.set_level("INFO", logger="bronko")
    index = build_index(21, genomes)
    out = tmp / f"choice_{counter}_{native_ok}"
    cfg = CallConfig(genomes=genomes, reads=[fq0], output=str(out), counter=counter)
    if used is None:
        with pytest.raises(SystemExit):
            run_call(cfg, index, build_device_index(index, CPU))
        assert "Sample" in caplog.text and "failed" in caplog.text
        return
    run_call(cfg, index, build_device_index(index, CPU))
    assert f"with the {used} counter" in caplog.text
    want = tmp / "choice_reference"
    if not want.exists():
        run_call(CallConfig(genomes=genomes, reads=[fq0], output=str(want), counter="host"),
                 index, build_device_index(index, CPU))
    assert _outputs(out) == _outputs(want)


def test_cli_device_counter_matches_jax(synth, monkeypatch):
    """`call --counter device` exits 0 and writes bronko_tpu's files."""
    tmp, genomes, (fq0, _) = synth
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    out = str(tmp / "cli_device")
    assert cli.main(["call", "-g", *genomes, "-r", fq0, "-o", out, "--pileup",
                     "--counter", "device"]) == 0
    jout = str(tmp / "cli_device_jax")
    index = jax_build.build_index(21, genomes)
    jax_engine.run_call(jax_config.CallConfig(genomes=genomes, reads=[fq0], output=jout,
                                              output_pileup=True, counter="device"),
                        index, jax_layout.build_device_index(index))
    assert _outputs(out) == _outputs(jout)


@pytest.mark.parametrize("extra", [
    ["-k", "20"],                               # validation: even k
    ["--mesh", "2x1"],
    ["--shard-samples"],
    ["--num-processes", "2"],
    ["--mesh", "1x1", "--device-build", "on"],  # validation: the mesh needs the host build
    ["--coordinator", "localhost:1234", "--num-processes", "1", "--process-id", "0"],
])
def test_cli_refuses_with_exit_1(synth, monkeypatch, extra):
    tmp, genomes, (fq0, _) = synth
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    assert _exit_code(["call", "-g", genomes[0], "-r", fq0,
                       "-o", str(tmp / "refused"), *extra]) == 1


@pytest.mark.parametrize("extra", [["--device-build", "on"], ["--device-build", "off"],
                                   ["--profile-dir", "prof"]])
def test_cli_device_build_and_profile_dir(synth, monkeypatch, extra):
    """Once refused: the device build and the profiler exit 0 and write the
    files of a plain call; the profiler writes its trace."""
    tmp, genomes, (fq0, _) = synth
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    want = tmp / "cli_plain"
    if not want.exists():
        assert cli.main(["call", "-g", *genomes, "-r", fq0, "-o", str(want)]) == 0
    out = tmp / f"cli_{extra[0][2:]}_{extra[1]}"
    if extra[0] == "--profile-dir":
        extra = [extra[0], str(tmp / "prof")]
    assert cli.main(["call", "-g", *genomes, "-r", fq0, "-o", str(out), *extra]) == 0
    assert _outputs(out) == _outputs(want)
    if extra[0] == "--profile-dir":
        assert any(f.endswith(".pt.trace.json") for f in os.listdir(extra[1]))


@pytest.mark.parametrize("platform", ["gpu", "tpu"])
def test_cli_never_falls_back_to_the_cpu(synth, monkeypatch, platform):
    """BRONKO_PLATFORM=gpu without a CUDA device, or a platform the port
    has no device for, exits 1 before any work."""
    tmp, genomes, (fq0, _) = synth
    monkeypatch.setenv("BRONKO_PLATFORM", platform)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp / f"nodevice_{platform}")
    assert _exit_code(["call", "-g", genomes[0], "-r", fq0, "-o", out]) == 1
    assert not os.path.exists(out)


def test_cli_exit_codes_for_failed_samples(synth, monkeypatch):
    tmp, genomes, (fq0, _) = synth
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    missing = str(tmp / "missing.fastq.gz")
    out = str(tmp / "partial")
    assert _exit_code(["call", "-g", genomes[0], "-r", missing, fq0, "-o", out]) == 2
    assert os.path.exists(os.path.join(out, "samp0.vcf"))
    assert _exit_code(["call", "-g", genomes[0], "-r", missing,
                       "-o", str(tmp / "allfail")]) == 1


def test_cli_refuses_an_index_outside_the_slice(tmp_path, synth, monkeypatch):
    """Nine genomes, past the single-word histogram, once refused: the call
    exits 0 and writes bronko_tpu's files (the multi-word histogram)."""
    import bronko_tpu.cli as jax_cli

    _, (ref, _), (fq0, _) = synth
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    rng = np.random.default_rng(9)
    seq = open(ref).read().split("\n", 1)[1].replace("\n", "").encode()
    genomes = [ref]
    for i in range(8):
        g = bytearray(seq)
        for p in rng.integers(0, len(g), 10):
            g[p] = b"ACGT"[(b"ACGT".index(g[p]) + 1) % 4]
        genomes.append(str(tmp_path / f"g{i}.fasta"))
        write_fasta(genomes[-1], f"g{i}", bytes(g))
    out, jout = str(tmp_path / "out"), str(tmp_path / "jax")
    assert cli.main(["call", "-g", *genomes, "-r", fq0, "-o", out, "--pileup"]) == 0
    assert jax_cli.main(["call", "-g", *genomes, "-r", fq0, "-o", jout, "--pileup"]) == 0
    assert len(_outputs(out)) == 3 and _outputs(out) == _outputs(jout)
    assert "\tref\t" in _outputs(out)["bronko_overview.tsv"]
