"""Every run's last line carries every metric its cell declares: each
end-to-end metric in every run, and each per-layer metric in a traced one
too, with the device fields, whatever ``--seconds`` is.  Each cell runs
here on the CPU, cut to a tiny size, from a window of a single chunk that
overran ``--seconds``; a stub runner gives a window of several chunks."""
from __future__ import annotations

import json
import math
import time
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness
from benchmark.tests import cpu_trace
from benchmark.tests.tiny import tiny_spec

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]
SEED = 2 ** 31 + 977


def _check_line(line: dict, spec, trace: bool) -> None:
    text = json.dumps(line)
    assert json.loads(text) == line
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    declared = spec.end_to_end + (spec.per_layer if trace else [])
    assert set(line["metrics"]) == {m["name"] for m in declared}
    for m in declared:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and math.isfinite(got["value"]), m["name"]
        if m["unit"] == "%":
            assert 0.0 <= got["value"] <= 100.0, m["name"]
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert 0 < len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert set(line["checks"]) == set(spec.limits)


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_single_chunk_window_reports_every_metric(cell, trace, monkeypatch):
    cpu_trace.patch(monkeypatch)
    torch.set_num_threads(4)
    spec = tiny_spec(cell)
    line = harness.run_cell(spec, SEED, 0.0, trace, torch.device("cpu"))
    _check_line(line, spec, trace)


class _StubRunner:
    """Chunks of a fixed host time and fixed work."""

    def setup(self, run, config, traffic):
        return {}

    def chunk(self, state, run):
        with run.span("gan"):
            time.sleep(0.04)
        with run.span("posenet"):
            time.sleep(0.01)
        return {"counts": {"units": 2, "iterations": 2, "clips": 1024, "posenet_steps": 16}}

    def check(self, state, run):
        return {"change_gap": math.nan}


def test_window_of_many_chunks_closes_after_seconds(monkeypatch):
    spec = harness.cell_spec("video-train")
    monkeypatch.setattr(harness, "runner_of", lambda spec: _StubRunner())
    line = harness.run_cell(spec, SEED, 0.12, False, torch.device("cpu"))
    _check_line(line, spec, False)
    assert all(c["value"] is None for c in line["checks"].values())
    assert line["correct"] is False
    assert line["attempted"] >= 6          # at least three whole chunks
    rate = line["metrics"]["video_train_clips_per_s"]["value"]
    assert rate == pytest.approx(512 * line["attempted"] / (0.05 * line["attempted"] / 2),
                                 rel=0.5)


def test_a_metric_that_reads_nothing_is_left_out(capsys):
    spec = harness.cell_spec("video-train")
    window = SimpleNamespace(seconds=1.0, chunks=1, counts=Counter())
    assert list(harness.read_metrics(spec, window, 1.0, False)) == ["setup_s"]
    assert "video_train_clips_per_s read nothing" in capsys.readouterr().err


def test_breakdown_names_idle_gaps_by_span_and_host_op():
    dev = [("k1", 100, 200), ("k2", 500, 600)]
    host = [("aten::item", 180, 520)]
    notes = [("gan", 0, 1000)]
    assert harness.device_ops(dev)[0][1] == pytest.approx(1e-7)
    gaps = dict((k, v) for k, v in harness.idle_gaps(dev, host, notes, (0, 1000)))
    assert gaps["gan / aten::item"] == pytest.approx(3e-7)
    assert harness._union_seconds([(0, 10), (5, 20), (30, 40)]) == pytest.approx(3e-8)
