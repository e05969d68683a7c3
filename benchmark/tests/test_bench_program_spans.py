"""The per-layer readers of the program's own spans read the traced chunks
that the window counts, and only those: two traced runs of each tiny cell
in one process, each read against its window's counts, so neither the
host-profiled chunk after the window nor an earlier run's records count.
The breakdown names idle gaps by the program's spans.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, program_spans
from benchmark.tests import cpu_trace
from benchmark.tests.tiny import tiny_spec

SEED = 2 ** 31 + 4243
CRITICS_AN_ITERATION = 12   # d3d 2, md3d 4, d2d 2, md2d 4: motion, flip and playback on


def _traced(cell: str, monkeypatch):
    """A traced tiny run of ``cell``: its line and what its readers saw."""
    seen = {}
    read_metrics = harness.read_metrics

    def keep(spec, window, setup_s, trace):
        seen["ctx"] = SimpleNamespace(window=window, traffic=spec.traffic, cell=spec.name)
        return read_metrics(spec, window, setup_s, trace)

    monkeypatch.setattr(harness, "read_metrics", keep)
    line = harness.run_cell(tiny_spec(cell), SEED, 0.0, True, torch.device("cpu"))
    return line, seen["ctx"]


@pytest.fixture
def cpu_cells(monkeypatch):
    cpu_trace.patch(monkeypatch)
    torch.set_num_threads(4)
    return monkeypatch


def test_video_readers_count_the_window_and_nothing_else(cpu_cells):
    for _ in range(2):
        line, ctx = _traced("video-train", cpu_cells)
        counts = ctx.window.counts
        gan = program_spans.counted(ctx, "gan.epoch", 1)
        assert len(program_spans.select(gan, "gan.epoch")) == ctx.window.chunks
        assert len(program_spans.select(gan, "gan.iteration")) == counts["iterations"]
        assert len(program_spans.select(gan, program_spans.is_critic)) == \
            CRITICS_AN_ITERATION * counts["iterations"]
        posenet = program_spans.counted(ctx, "posenet.pass", 2)
        assert len(program_spans.select(posenet, "posenet.step")) == counts["posenet_steps"]
        reskin = program_spans.counted(ctx, "reskin.update", 1)
        assert len(program_spans.select(reskin, "reskin.update")) == ctx.window.chunks
        metrics = {k: v["value"] for k, v in line["metrics"].items()}
        assert metrics["gan_syncs_per_iter.video"] == 0.0       # no CUDA here
        assert 0 < metrics["critic_host_ms_per_update.video"] \
            < metrics["gan_host_ms_per_iter.video"]
        assert metrics["posenet_host_ms_per_step.video"] > 0
        assert metrics["reskin_ms_per_iter.video"] > 0


def test_synth_readers_count_the_window_and_gaps_name_program_spans(cpu_cells):
    for _ in range(2):
        line, ctx = _traced("single-synth", cpu_cells)
        spans = program_spans.counted(ctx, "synth.dispatch", ctx.traffic["chunk_batches"])
        assert len(program_spans.select(spans, "synth.dispatch")) == \
            ctx.window.counts["dispatches"]
        for part in ("synth.trunk", "synth.angles", "synth.fk", "synth.project"):
            assert len(program_spans.select(spans, part)) == ctx.window.counts["dispatches"]
        assert line["metrics"]["synth_syncs_per_dispatch"]["value"] == 0.0
        assert line["metrics"]["synth_host_us_per_dispatch"]["value"] > 0
        assert any(label.startswith("synth.") for label, _ in line["breakdown"]["idle_gaps"])


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """A checkout whose program records no spans (the parent of the
    recorder): every span reader returns None and raises nothing."""
    import dhaug_torch.utils.profiling as profiling

    monkeypatch.delattr(profiling, "span_records")
    ctx = SimpleNamespace(window=SimpleNamespace(chunks=2, counts={"iterations": 8}),
                          traffic={"chunk_batches": 3}, cell="any")
    manifest = harness.load_manifest()
    for metric in manifest["per_layer"]:
        if metric["source"] in ("program_span", "program_counter") and \
                metric["name"] not in ("gan_ms_per_iter.video", "posenet_ms_per_step.video"):
            module = harness.load_module(harness.BENCH / "metrics" / f"{metric['name']}.py")
            assert module.read(ctx) is None, metric["name"]
