"""The control of `correct` at a size a test holds: the reference with its
caller in float32, in the program's place, fails the comparison on every
sample, while the reference as it stands passes it and calls every
planted major."""

from __future__ import annotations

import pytest
import torch
from conftest import CELLS, tiny

from portbench import control


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_sound_passes(cache, cell):
    _, config, traffic = tiny(cell)
    for seed in (2**31 + 1, 2**31 + 2):
        r = control.readings(config, traffic, seed, torch.device("cpu"), cache)
        assert r["control"]["calls"] == traffic["samples"], r
        assert r["sound_self"] == 0 and r["sound_majors_missing"] == 0, r
