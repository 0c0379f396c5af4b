"""A whole run of each cell, tiny and on the CPU, past the look for a card:
`correct` holds for the program as it is and comes out false with the
timed path broken underneath, once for each fault the cell can have. The
exchange between chips has no fault here: both cells run on one chip."""

from __future__ import annotations

import time

import pytest
import torch
from conftest import CELLS, tiny

from portbench import checks, harness


def _drop_half(real):
    def to_batches(kmers, counts, batch_size, device):
        half = kmers.shape[0] // 2  # half the k-mers left out
        return real(kmers[:half], counts[:half], batch_size, device)
    return to_batches


def _alter_answer(real):
    def call_variants_for_seq(*args, **kwargs):
        records = real(*args, **kwargs)
        if records:
            records[0].af += 1e-6  # an answer altered where it is produced
        return records
    return call_variants_for_seq


def _unchanged(real):
    def walk_scatter(pileup, *args, **kwargs):
        return None  # pass 2 returns the pileup as it was given
    return walk_scatter


FAULTS = {
    "half_the_kmers": ("bronko_tpu_torch.call.engine", "to_batches", _drop_half),
    "altered_answer": ("bronko_tpu_torch.call.engine", "call_variants_for_seq", _alter_answer),
    "state_unchanged": ("bronko_tpu_torch.ops.map", "walk_scatter", _unchanged),
}


def _run(cell_name: str, cache: str) -> dict:
    cell, config, traffic = tiny(cell_name)
    return harness.run_cell(cell, config, traffic, 2**31 + 99, 0.0, False,
                            torch.device("cpu"), time.perf_counter(), cache=cache)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cpu_program, cache, cell):
    record = _run(cell, cache)
    assert checks.correct(record["checks"]), record["checks"]
    assert all(s["ok"] for c in record["calls"] for s in c["samples"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_run_incorrect(cpu_program, cache, monkeypatch, cell, fault):
    import importlib

    module, name, wrap = FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    record = _run(cell, cache)
    assert not checks.correct(record["checks"]), record["checks"]
