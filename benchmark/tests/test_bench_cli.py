"""The command's refusals: without as many cards as the cell asks for it
exits non-zero and prints no result, and so it does for a workload the
manifest lacks."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from benchmark import harness


def _run(*args):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")
    out = _run("--workload", "single-synth", "--seed", str(2 ** 31 + 5), "--seconds", "1")
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_unknown_workload_no_result():
    out = _run("--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout.strip() == ""
