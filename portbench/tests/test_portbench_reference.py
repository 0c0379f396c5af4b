"""The plain reference against the port's CPU run (its plain kernels) at a
tiny size, on the single histogram word and on the flat tally."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import CELLS, tiny

from portbench import checks, gen
from portbench.reference import Reference, mapper


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_port(cpu_program, tmp_path, cell):
    from portbench.system import System

    _, config, traffic = tiny(cell)
    inputs = gen.prepare(config, traffic, 21, str(tmp_path / "cache"))
    system = System(config, traffic, inputs.strains, inputs.folder, torch.device("cpu"))
    pairs = [(s.r1, s.r2) for s in inputs.samples]
    cfg = system.config_for(pairs, str(tmp_path / "out"))
    system.load_index(cfg)
    results = system.call(cfg)
    assert len(results) == len(pairs)
    ref = Reference(inputs.codes, inputs.names, config["k"], device=torch.device("cpu"))
    refs = dict(enumerate(ref.run_many([list(p) for p in pairs])))
    window = [{"id": i, "name": s.r1, "result": r}
              for i, (s, r) in enumerate(zip(inputs.samples, results))]
    counts = checks.compare_samples(window, refs, {s.index: s.majors for s in inputs.samples})
    assert counts == dict.fromkeys(counts, 0)
    assert all(r.records for r in refs.values())
    want = ("flat", "subindex") if config["strains"] > 255 else ("hist",)
    assert all(r.path[:len(want)] == want for r in results)


def test_keys_separate_position_and_other_bases():
    """Two k-mers share a query key at position i exactly when they differ
    at most at i."""
    k, pos = 21, mapper.positions(21, 2, False)
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.integers(0, 1 << 42, 64, dtype=np.int64))
    i = pos[3]
    shift = 2 * (k - 1 - i)
    other = base ^ (1 << shift)  # differs at i only
    far = base ^ (1 << (shift + 2))  # differs at the position before i
    kb, ko, kf = (mapper.masked_keys(x, k, pos) for x in (base, other, far))
    assert torch.equal(kb[:, 3], ko[:, 3])
    assert not torch.equal(kb[:, 3], kf[:, 3])
    assert (kb[:, 3][:, None] != kb[:, [j for j in range(len(pos)) if j != 3]]).all()


@pytest.mark.cuda
def test_reference_on_card_equals_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, config, traffic = tiny("sars2-panel300.cohort")
    inputs = gen.prepare(config, traffic, 4, str(tmp_path))
    paths = [[s.r1, s.r2] for s in inputs.samples]
    cpu = Reference(inputs.codes, inputs.names, config["k"]).run_many(paths)
    card = Reference(inputs.codes, inputs.names, config["k"],
                     device=torch.device("cuda", 0)).run_many(paths)
    for a, b in zip(cpu, card):
        assert a.best == b.best and a.reads == b.reads and a.work == b.work
        assert np.array_equal(a.tallies, b.tallies) and np.array_equal(a.pileup, b.pileup)
        assert a.records == b.records and a.overview == b.overview


def test_reference_tau_equals_the_programs_table():
    """The reference's tau, from its formula, equals the program's
    correctly rounded table at every window size the scan reaches."""
    from bronko_tpu_torch.call._tau_golden import N_MAX, TAU

    from portbench.reference import noise

    assert noise._tau(2) == np.inf
    assert [noise._tau(n) for n in range(3, N_MAX)] == TAU[3:N_MAX]


def test_a_major_called_with_another_base_is_counted(cpu_program, tmp_path):
    """A major's PASS record at its site but with another alt base does not
    count as the planted major."""
    import dataclasses

    from portbench.system import System

    _, config, traffic = tiny("sars2-4ref.single")
    inputs = gen.prepare(config, traffic, 22, str(tmp_path / "cache"))
    s = inputs.samples[0]
    system = System(config, traffic, inputs.strains, inputs.folder, torch.device("cpu"))
    cfg = system.config_for([(s.r1, s.r2)], str(tmp_path / "out"))
    system.load_index(cfg)
    res = system.call(cfg)[0]
    ref = Reference(inputs.codes, inputs.names, config["k"], device=torch.device("cpu"))
    refs = {0: ref.run_many([[s.r1, s.r2]])[0]}
    window = [{"id": 0, "name": s.r1, "result": res}]
    assert checks.compare_samples(window, refs, {0: s.majors})["majors"] == 0
    pos, alt = s.majors[0]
    res.records = [dataclasses.replace(r, alt_base=(alt + 1) % 4) if r.pos - 1 == pos else r
                   for r in res.records]
    assert checks.compare_samples(window, refs, {0: s.majors})["majors"] == 1
