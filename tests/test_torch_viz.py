"""The port's pictures and profiling helpers on the CPU: every plotter of
dhaug_torch/utils/viz.py writes its file; ``--record_all_picture`` writes the
same files as the JAX CLI on the same argv, single-frame and video;
``run_baseline`` draws ``log.png`` (and skips the plot with a message where
it fails, as the JAX CLI does); utils/profiling.py's ``timed`` and ``fence`` behave as the JAX helpers do,
and ``trace`` writes a trace file and the block's span table."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import run_Fk_GAN as jax_fk_gan
from dhaug_torch import run_baseline, run_fk_gan
from dhaug_torch.train import video_runner
from dhaug_torch.utils import profiling as t_prof
from dhaug_torch.utils import viz as t_viz
from dhaug_tpu.models import factory as j_factory
from dhaug_tpu.utils import profiling as j_prof
from dhaug_tpu.utils import viz as j_viz
from test_torch_jax_checkpoints import _jax_narrow, _torch_narrow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLOTTERS = ["plot_pose_grid_3d", "plot_pose_grid_2d", "plot_paper_pose3d_row",
            "plot_paper_pose2d", "plot_fake_real_pairs_3d", "plot_video_strip",
            "plot_dof_angle_heatmap", "plot_scalar_curves", "render_animation",
            "plot_angle_pair_density", "plot_metric_curves"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_viz_has_the_jax_plotters():
    public = lambda m: sorted(n for n in dir(m) if n.startswith(("plot_", "render_")))
    assert public(t_viz) == public(j_viz) == sorted(PLOTTERS)


def _plot_args(name, tmp_path):
    rng = np.random.default_rng(0)
    p3 = rng.normal(size=(6, 16, 3)).astype(np.float32) * 0.3
    p2 = rng.normal(size=(6, 16, 2)).astype(np.float32) * 0.3
    if name == "plot_metric_curves":
        log = tmp_path / "log.txt"
        log.write_text("epoch\tlr\terror_h36m_p1\terror_3dhp_p1\n1\t0.001\t90.5\t120.0\n"
                       "2\t0.0009\t80.25\t110.0\n")
        return (str(log),)
    return {"plot_pose_grid_3d": (p3,), "plot_pose_grid_2d": (p2,),
            "plot_paper_pose3d_row": (p3,), "plot_paper_pose2d": (p2[0],),
            "plot_fake_real_pairs_3d": (p3, p3[::-1]), "plot_video_strip": (p3[:3], p2[:3]),
            "plot_dof_angle_heatmap": (rng.uniform(-180, 180, (64, 37)),),
            "plot_scalar_curves": ({"3d_wasserstein": [0.5, 0.25, 0.1]},),
            "plot_angle_pair_density": (rng.uniform(-180, 180, (64, 37)),)}[name]


@pytest.mark.parametrize("name", PLOTTERS)
def test_every_plotter_writes_a_file(name, tmp_path):
    ext = ".gif" if name == "render_animation" else ".png"
    path = str(tmp_path / f"{name}{ext}")
    if name == "render_animation":
        rng = np.random.default_rng(1)
        out = t_viz.render_animation(path, rng.normal(size=(3, 16, 3)) * 0.3,
                                     gt3d=rng.normal(size=(3, 16, 3)) * 0.3,
                                     input2d=rng.normal(size=(3, 16, 2)) * 0.3, fps=5)
    else:
        out = getattr(t_viz, name)(*_plot_args(name, tmp_path), path)
    assert out == path and os.path.getsize(path) > 0


# 1 epoch of 4 GAN iterations (1200 frames in batches of 256), nets 32 wide
TINY = ["--lr_p", "1e-3", "--keypoints", "gt", "--batch_size", "256", "--downsample", "4",
        "--epochs", "1", "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
        "--Gen_DenseDim", "32", "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32",
        "--video_Dis_DenseDim_3D", "32", "--video_Dis_DenseDim_2D", "32",
        "--record_all_picture", "true", "--data_root", REPO]
MODES = {"single": ["--posenet_name", "mlp"],
         # 600 frames (--downsample 8) in clips of 3 frames, batches of 64;
         # the motion critics from epoch 0
         "multi": ["--posenet_name", "mulit_farme_videopose", "--single_or_multi_train_mode",
                   "multi", "--architecture", "3", "--batch_size", "64", "--downsample", "8",
                   "--single_dis_warmup_epoch", "0"]}


def _written(checkpoint_dir):
    """The file names a run wrote, relative to its run directory, but the
    TensorBoard event files the JAX package adds where tensorboardX
    imports (the port writes its scalars to metrics.jsonl only)."""
    (run_dir,) = glob.glob(os.path.join(checkpoint_dir, "*", "*", "*"))
    return sorted(os.path.relpath(os.path.join(root, f), run_dir)
                  for root, _, files in os.walk(run_dir) for f in files
                  if not f.startswith("events.out.tfevents"))


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_record_all_picture_writes_the_jax_files(mode, tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(j_factory, "make_posenet", _jax_narrow)
    monkeypatch.setattr(video_runner, "make_posenet", _torch_narrow)
    argv = TINY + MODES[mode]
    jax_fk_gan.main(argv + ["--checkpoint", str(tmp_path / "jax")])
    run_fk_gan.main(argv + ["--checkpoint", str(tmp_path / "port"), "--device", "cpu"])
    jax_files, port_files = _written(tmp_path / "jax"), _written(tmp_path / "port")
    assert port_files == jax_files
    pictures = [f for f in port_files if f.endswith((".jpg", ".png"))]
    assert "wasserstein_curves.png" in pictures
    assert any(f.startswith("tmp/") for f in pictures)
    if mode == "single":
        assert "tmp/34DOF_3GlobalRot_heatmap_1.jpg" in pictures
    else:
        assert {"tmp/fake_video_ep0.jpg", "tmp/real_video_ep0.jpg"} <= set(pictures)


BASELINE = ["--posenet_name", "mlp", "--stages", "1", "--batch_size", "512", "--epochs", "1",
            "--data_root", REPO, "--device", "cpu"]


def test_run_baseline_draws_log_png(tmp_path):
    out = run_baseline.main(BASELINE + ["--checkpoint", str(tmp_path)])
    assert os.path.getsize(os.path.join(out["run_dir"], "log.png")) > 0


def test_run_baseline_goes_on_when_the_plot_fails(tmp_path, monkeypatch, capsys):
    """Without matplotlib (or on any plotting error) the JAX CLI prints why
    and finishes the run; the port does the same."""
    def no_matplotlib(*_):
        raise ModuleNotFoundError("No module named 'matplotlib'")
    monkeypatch.setattr(run_baseline, "plot_metric_curves", no_matplotlib)
    out = run_baseline.main(BASELINE + ["--checkpoint", str(tmp_path)])
    assert "(metric plot skipped: No module named 'matplotlib')" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(out["run_dir"], "log.png"))
    assert np.isfinite(out["best_h36m"])


def test_timed_and_fence_keep_the_jax_helpers_behaviour():
    x = torch.ones(8)
    out, seconds = t_prof.timed(lambda a: a * 2, x, iters=3)
    j_out, j_seconds = j_prof.timed(lambda a: a * 2, np.ones(8), iters=3)
    assert torch.equal(out, x * 2) and seconds >= 0.0
    np.testing.assert_array_equal(np.asarray(j_out), out.numpy())
    assert j_seconds >= 0.0
    t_prof.fence({"a": [None, (x,)]})   # a CPU tensor: nothing to wait for
    t_prof.fence(None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_prof.trace(str(tmp_path / "trace")):
        with t_prof.span("viz.block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.json"
    assert path.is_file() and path.stat().st_size > 0
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert list(spans) == ["viz.block"]
    assert spans["viz.block"]["calls"] == 1 and spans["viz.block"]["total_ms"] > 0
    assert "viz.block" in path.read_text()
