"""The seeded generator: the same seed gives the same bytes, the shapes are
the mix's, the strains and planted sites are as stated."""

from __future__ import annotations

import numpy as np
import pytest
from conftest import tiny

from portbench import gen
from portbench.reference.reads import read_codes


def _bytes(inputs) -> list[bytes]:
    out = []
    for s in inputs.samples:
        for p in (s.r1, s.r2):
            with open(p, "rb") as fh:
                out.append(fh.read())
    return out


def test_same_seed_same_inputs(tmp_path):
    _, config, traffic = tiny("sars2-4ref.single")
    a = gen.prepare(config, traffic, 2**31 + 11, str(tmp_path / "a"))
    b = gen.prepare(config, traffic, 2**31 + 11, str(tmp_path / "b"))
    c = gen.prepare(config, traffic, 2**31 + 12, str(tmp_path / "c"))
    assert _bytes(a) == _bytes(b)
    assert [s.planted for s in a.samples] == [s.planted for s in b.samples]
    assert all(x != y for x, y in zip(_bytes(a), _bytes(c)))
    # the strains, and so the index, do not follow the seed
    assert all(np.array_equal(x, y) for x, y in zip(a.codes, c.codes))


@pytest.mark.parametrize("cell", ["sars2-4ref.single", "sars2-panel300.cohort"])
def test_sample_shapes(tmp_path, cell):
    _, config, traffic = tiny(cell)
    inputs = gen.prepare(config, traffic, 5, str(tmp_path))
    assert len(inputs.samples) == traffic["samples"]
    for s in inputs.samples:
        assert s.strain == (traffic["strain_stride"] * s.index) % config["strains"]
        for path in (s.r1, s.r2):
            codes, lengths = read_codes(path)
            assert codes.shape == (traffic["pairs"], traffic["read_len"])
            assert (lengths == traffic["read_len"]).all() and (codes < 4).all()
        with open(s.r1.replace("_R1", "_R2"), "rb") as fh:
            assert fh.read(2) == b"\x1f\x8b"  # gzip, as a sequencer hands it over


def test_strains(tmp_path):
    _, config, traffic = tiny("sars2-4ref.single")
    codes = gen.strain_codes(config)
    base = codes[config["base_strain"]]
    assert len(codes) == config["strains"]
    for j, c in enumerate(codes):
        assert c.shape == (config["genome_len"],)
        assert int((c != base).sum()) == (0 if j == config["base_strain"]
                                          else config["snps_per_strain"])
    inputs = gen.prepare(config, traffic, 5, str(tmp_path))
    with open(inputs.strains[0]) as fh:
        head, *lines = fh.read().split()
    assert head == f">{inputs.names[0]}"
    assert "".join(lines) == gen.ASCII[codes[0]].tobytes().decode()


def test_planted_sites(tmp_path):
    _, config, traffic = tiny("sars2-4ref.single")
    inputs = gen.prepare(config, traffic, 9, str(tmp_path))
    for s in inputs.samples:
        strain = inputs.codes[s.strain]
        sites = sorted(p for p, *_ in s.planted)
        kinds = [k for *_, k in s.planted]
        assert kinds.count("major") == traffic["majors"]
        assert kinds.count("minor") == traffic["minors"]
        assert sites[0] >= traffic["site_margin"]
        assert sites[-1] < config["genome_len"] - traffic["site_margin"]
        assert min(np.diff(sites)) >= traffic["site_gap"]
        assert all(a != strain[p] for p, a, _, _ in s.planted)
        lo, hi = traffic["minor_af"]
        assert all(f == traffic["major_af"] if k == "major" else lo <= f <= hi
                   for _, _, f, k in s.planted)


def test_majors_carried_at_their_fraction(tmp_path):
    """About major_af of the R1 reads over a major site carry its alt."""
    _, config, traffic = tiny("sars2-4ref.single")
    s = gen.prepare(config, traffic, 3, str(tmp_path)).samples[0]
    strain = gen.strain_codes(config)[s.strain]
    r1, _, planted = gen.make_sample(strain, traffic, 3, 0)
    assert planted == s.planted
    rl = traffic["read_len"]
    for p, a, f, kind in planted:
        if kind != "major":
            continue
        # forward R1 reads that start at a known offset before the site
        for off in (10, 60):
            window = strain[p - off:p - off + rl]
            rows = r1[(r1[:, :off] == window[:off]).all(axis=1)]
            if len(rows) >= 30:
                assert abs((rows[:, off] == a).mean() - f) < 0.2
