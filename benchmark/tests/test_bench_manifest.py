"""The manifest and the files it names: every cell finds its configuration,
traffic, runner and limits, every metric its reader, every per-layer
metric's cells report the metric it moves, the manifest keeps to the
benchmark's contract, and a cell added as files is found with no edit.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = harness.BENCH
MANIFEST = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in MANIFEST["command"])
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cells = 24
    check = 2 + 14 * cells
    assert check * (MANIFEST["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    entry = next(w for w in MANIFEST["workloads"] if w["name"] == cell)
    config = next(c for c in MANIFEST["configs"] if c["name"] == entry["config"])
    assert (ROOT / config["file"]).is_file()
    traffic = BENCH / "traffic" / f"{entry['traffic']}.json"
    assert traffic.is_file()
    assert (BENCH / "runners" / f"{json.loads(traffic.read_text())['runner']}.py").is_file()
    spec = harness.cell_spec(cell)
    assert spec.limits and all(v > 0 for v in spec.limits.values())
    assert entry["chips"] == 1 and len(entry["why"]) <= 200


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_a_reader(metric):
    module = harness.load_module(BENCH / "metrics" / f"{metric}.py")
    assert callable(module.read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_its_layer_metrics_move(cell):
    spec = harness.cell_spec(cell)
    reported = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.per_layer
    for metric in spec.per_layer:
        assert metric["moves"] in reported, (cell, metric["name"])


def test_names_units_and_keys():
    keys = {"name", "unit", "better", "source"}
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= keys | {"bound", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) <= keys | {"layer", "moves", "workloads"}
        assert all(c in CELLS for c in m.get("workloads", []))
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(MANIFEST).encode()) <= 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_file_keeps_its_widths(config):
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert set(entry["reduced"]) <= set(data["reduced"])
    assert all(k in data for k in entry["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_dense")) for k in entry["reduced"])
    gan = data["gan"]
    assert gan["gen_dense"] == gan["dis_dense_3d"] == gan["dis_dense_2d"] == 1000


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_argv_states_what_the_reference_reads(config):
    """The program reads the CLI flags, the reference the numbers beside
    them: they have to agree."""
    from dhaug_torch.train.config import parse_aug_args

    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    args, gan, pose = parse_aug_args(data["argv"]), data["gan"], data["posenet"]
    assert (args.Gen_DenseDim, args.Dis_DenseDim_3D, args.Dis_DenseDim_2D) == \
        (gan["gen_dense"], gan["dis_dense_3d"], gan["dis_dense_2d"])
    assert (args.GAN_LAMBDA, args.GAN_3d_loss_weight, args.GAN_2d_loss_weight) == \
        (gan["lambda_gp"], gan["w3d"], gan["w2d"])
    assert (args.lr_g, args.lr_d, args.lr_p) == (gan["lr_g"], gan["lr_d"], pose["lr"])
    assert args.dropout == pose["dropout"] and args.max_norm and pose["max_norm"] == 1.0
    assert args.flip_GAN_model_input and args.flip_pos_model_input
    assert args.posenet_name == pose["name"]
    if "video_dis_dense_3d" in gan:
        assert (args.video_Dis_DenseDim_3D, args.video_Dis_DenseDim_2D) == \
            (gan["video_dis_dense_3d"], gan["video_dis_dense_2d"])
        assert args.architecture == ",".join(map(str, pose["filter_widths"]))
        assert args.GAN_video_playback_input and args.Pos_video_playback_input
        assert args.motion_Dis_whether_use_3dPos_branch and \
            args.motion_Dis_whether_use_3dDiff_branch
    else:
        assert args.stages == pose["stages"]


def test_a_cell_added_as_files_is_found(tmp_path: Path):
    """A later cell needs only data: a manifest entry, a traffic file and a
    limits file (and reader files for new metrics)."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_out", "_cache", "__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({"name": "video-train-b256", "config": "dhaug-video-videopose",
                                  "traffic": "video_train_b256", "chips": 1,
                                  "why": "a later cell"})
    rate = next(m for m in manifest["end_to_end"] if m["name"] == "video_train_clips_per_s")
    rate["workloads"].append("video-train-b256")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = json.loads((BENCH / "traffic" / "video_train_chunks.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "video_train_b256.json").write_text(
        json.dumps(dict(traffic, batch=256, chunk_batches=8)))
    (tmp_path / "benchmark" / "workloads" / "video-train-b256.json").write_text(
        (BENCH / "workloads" / "video-train.json").read_text())
    spec = harness.cell_spec("video-train-b256", root=tmp_path)
    assert spec.traffic["batch"] == 256
    assert [m["name"] for m in spec.end_to_end] == ["setup_s", "video_train_clips_per_s"]
    assert spec.per_layer == []
