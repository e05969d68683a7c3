"""The check that decides ``correct`` fails a broken timed path.  Each test
skips the harness's look for a chip, drives the rest of a run of a cell cut
to a tiny size on the CPU with a fault of ``benchmark/faults.py`` planted in
the program underneath, and sees ``correct`` come out false, the broken
number well above the same seed's sound run.  The controls (the reference
one precision lower) read well above the sound run too."""
from __future__ import annotations

import pytest
import torch

from benchmark import faults, harness, pool
from benchmark.tests.tiny import tiny_spec

SEED = 2 ** 31 + 4242
CELLS = ("video-train", "single-synth")
CASES = [(cell, name) for cell in CELLS for name in faults.of(tiny_spec(cell))]


def _run(spec):
    torch.set_num_threads(4)
    return harness.run_cell(spec, SEED, 0.0, False, torch.device("cpu"))


def _readings(line):
    return {k: v["value"] for k, v in line["checks"].items()}


@pytest.fixture(scope="module")
def sound():
    return {cell: _readings(_run(tiny_spec(cell))) for cell in CELLS}


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, sound):
    spec = tiny_spec(cell)
    faults.of(spec)[fault](spec, monkeypatch.setattr)
    line = _run(spec)
    assert line["correct"] is False
    broken = _readings(line)
    assert any(broken[k] >= 10 * sound[cell][k] for k in broken), (broken, sound[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_sound_run(cell, sound):
    """The control, the reference one precision lower in the program's
    place, reads ten times the sound run or more on a compared number.  At
    the tiny size the gaps are smaller than at the cell's own; the chip
    readings at full size, against the committed limits, are in
    ``benchmark/workloads/<cell>.json``."""
    spec = tiny_spec(cell)
    runner = harness.runner_of(spec)
    for seed in (11, 12, 13):
        values = runner.control(spec.config, spec.traffic, pool.seeds(seed),
                                torch.device("cpu"))
        assert any(values[k] > 10 * sound[cell][k] for k in spec.limits), (seed, values)
