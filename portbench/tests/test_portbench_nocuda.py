"""Without a CUDA card, or without the program beside it, a run exits
non-zero and prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

ARGS = ["--workload", "sars2-4ref.single", "--seed", str(2**31 + 3), "--seconds", "1",
        "--trace", "0"]


def _no_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return True
    try:
        json.loads(lines[-1])
    except ValueError:
        return True
    return False


def test_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and _no_result(p.stdout)
    assert "CUDA" in p.stderr


def test_refuses_without_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and _no_result(p.stdout)
