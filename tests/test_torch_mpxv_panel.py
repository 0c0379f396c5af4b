"""The mpox panel configuration (portbench/configs/mpxv-16ref.json) cut to a
CPU's size, through the port's normal path, against the benchmark's plain
reference (portbench/reference/).

16 strains of a 12,000 bp genome (G = 16: the multi-word histogram, W = 2)
and lone paired-end samples of 3,000 pairs, each called alone as the
`single400k` mix calls them, at --batch-size 4096 so that every sample
spans several device batches. --min-depth is lowered in the program and
the reference alike, so that records exist at this depth. Tallies, the
selected genome, the int32 pileup, the VCF records and the VCF and
overview text must equal the reference's, on the classic and the
streamed path."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import checks, gen, harness  # noqa: E402
from portbench.reference import Reference  # noqa: E402
from portbench.reference.outputs import clean_sample_id  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BATCH = 4096
MIN_DEPTH = 30


def _cut():
    """(config, traffic) of the mpox cell, cut to a CPU's size: every key
    the cut leaves alone is the benchmark's."""
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, config, traffic = harness.load_cell(bench, "mpxv-16ref.single400k")
    assert (config["strains"], config["k"], config["index"]) == (16, 21, "db")
    config.update(genome_len=12_000, snps_per_strain=24,
                  call_args=[*config["call_args"], "--batch-size", str(BATCH),
                             "--min-depth", str(MIN_DEPTH)],
                  reference_params={"min_depth": MIN_DEPTH})
    traffic.update(samples=3, pairs=3_000)
    return config, traffic


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """The cut configuration's inputs and the reference's answer for each
    sample."""
    config, traffic = _cut()
    inputs = gen.prepare(config, traffic, 2**31 + 17, str(tmp_path_factory.mktemp("mpxv")))
    ref = Reference(inputs.codes, inputs.names, config["k"], config["reference_params"], CPU)
    refs = ref.run_many([[s.r1, s.r2] for s in inputs.samples])
    return config, traffic, inputs, ref, refs


@pytest.mark.parametrize("stream", ["0", "1"], ids=["classic", "streamed"])
def test_mpxv_panel_equals_the_reference(panel, tmp_path, monkeypatch, stream):
    from portbench.system import System

    config, traffic, inputs, ref, refs = panel
    monkeypatch.setenv("BRONKO_PLATFORM", "cpu")
    for flag in ("BRONKO_NO_STREAM", "BRONKO_STREAM_FIRST"):
        monkeypatch.delenv(flag, raising=False)
    monkeypatch.setenv("BRONKO_STREAM", stream)
    system = System(config, traffic, inputs.strains, inputs.folder, CPU)
    out = str(tmp_path / "out")
    system.load_index(system.config_for([(inputs.samples[0].r1, inputs.samples[0].r2)], out))
    assert system.dev.num_genomes == 16 and system.dev.hist is None
    assert system.dev.hist_words.shape[1] == 2

    for s, want in zip(inputs.samples, refs):
        (res,) = system.call(system.config_for([(s.r1, s.r2)], out))
        assert res.path == ("words", "streamed" if stream == "1" else "saved")
        assert res.counts["words"] == 2 and res.counts["batches"] > 1
        assert res.best == want.best and np.array_equal(res.tallies, want.tallies)
        assert res.pileup.dtype == np.int32 and np.array_equal(res.pileup, want.pileup)
        assert res.records and want.records
        window = [{"id": 0, "name": s.r1, "result": res}]
        found = checks.compare(window, {0: want}, {0: s.majors},
                               lambda name, _: ref.vcf(name, want), out, window)
        assert found == {k: {"value": 0, "limit": 0} for k in checks.NAMES}
        with open(os.path.join(out, clean_sample_id(s.r1) + ".vcf")) as fh:
            assert fh.read() == ref.vcf(s.r1, want)
