"""Tensor parallelism through the port's CLIs and checkpoints on the CPU:
snapshots of a (1, 2) grid in the single-device layout, and
``--model_parallel_devices`` on ``run_fk_gan`` (both modes) and
``run_baseline``, gloo ranks of one thread each.  The GAN nets run at
width 512, the narrowest that ``parallel/tensor.TP_MIN_WIDTH`` shards (the
CLIs assert that the model axis sharded a layer)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import test_torch_tp_worker as worker
from dhaug_torch.parallel import mesh
from test_torch_parallel import _env, _one_intra_op_thread  # noqa: F401
from test_torch_tp import on_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 32
WIDE = ["--Gen_DenseDim", "512", "--Dis_DenseDim_3D", "512", "--Dis_DenseDim_2D", "512"]


@pytest.mark.parametrize("fmt", ["pickle", "orbax"])
def test_a_tp2_snapshot_loads_bit_identically_into_one_process_and_tp2(fmt, tmp_path):
    """The GAN nets and their Adam states written on tp2 (global rank 0
    writes the gathered blocks) load into one process as the two ranks'
    blocks put together, and into tp2 as each rank's own blocks, bit for
    bit."""
    ranks = on_grid("snapshot", W, str(tmp_path), fmt)
    path = ranks[0]["path"]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    one = worker.restore(W, path)["local"]
    joined = lambda whole, x, y: x if x.shape == whole.shape else np.concatenate([x, y])
    for whole, a, b in zip(one, ranks[0]["local"], ranks[1]["local"]):
        for key, w in whole["model"].items():
            assert np.array_equal(joined(w, a["model"][key], b["model"][key]), w), key
        for i, state in whole["opt"].items():
            for k, w in state.items():
                assert np.array_equal(joined(w, a["opt"][i][k], b["opt"][i][k]), w), (i, k)
    again = on_grid("restore", W, path)
    for r, back in enumerate(again):
        for got, want in zip(back["local"], ranks[r]["local"]):
            for key, v in want["model"].items():
                assert np.array_equal(got["model"][key], v), (r, key)
            for i, s in want["opt"].items():
                assert all(np.array_equal(got["opt"][i][k], s[k]) for k in s), (r, i)


TINY_WIDE = ["--posenet_name", "mlp", "--lr_p", "1e-3", "--keypoints", "gt",
             "--batch_size", "512", "--data_enhancement_method", "GAN",
             "--single_or_multi_train_mode", "single", "--epochs", "2",
             "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
             "--downsample", "4", *WIDE, "--data_root", REPO, "--device", "cpu"]


def test_cli_trains_on_tp2_and_only_global_rank_0_writes(tmp_path):
    """``python -m dhaug_torch.run_fk_gan --model_parallel_devices 2``: the
    CLI's own launcher starts the two ranks; one run directory with the
    single-frame files, the snapshot in the single-device layout (it
    resumes in one process), and no kernel launch on the CPU."""
    from dhaug_torch import run_fk_gan
    from dhaug_torch.utils.checkpoint import load_snapshot
    code = (
        "import json, sys\n"
        "from dhaug_torch import run_fk_gan\n"
        "out = run_fk_gan.main(sys.argv[1:])\n"
        "print(json.dumps({'ranks': out['rank_launches'], 'run_dir': out['run_dir'],\n"
        "                  'scores': out['scores'], 'scalars': out['epoch_scalars']}))\n")
    proc = subprocess.run([sys.executable, "-c", code, *TINY_WIDE, "--model_parallel_devices",
                           "2", "--checkpoint", str(tmp_path / "tp")],
                          capture_output=True, text=True, env=_env(), cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Parallel grid: 1 x 2 ranks (data x model)" in proc.stdout
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ranks"] == [{"fwd": 0, "bwd": 0, "trunk": 0}] * 2
    for scores in result["scores"].values():
        assert all(np.isfinite(v) and v > 0 for v in scores.values())
    run_dir = result["run_dir"]
    assert os.listdir(os.path.join(str(tmp_path), "tp", "mlp", "gt")) == \
        [os.path.basename(run_dir)]
    assert sorted(os.listdir(run_dir)) == ["ckpt_best_dhp_p1.ckpt", "ckpt_best_h36m_p1.ckpt",
                                           "ckpt_resume_latest.ckpt", "log.txt",
                                           "metrics.jsonl", "tmp"]
    lines = [json.loads(x) for x in open(os.path.join(run_dir, "metrics.jsonl"))]
    keys = [(x["tag"], x["step"]) for x in lines]
    assert len(keys) == len(set(keys))
    snapshot = os.path.join(run_dir, "ckpt_resume_latest.ckpt")
    saved = load_snapshot(snapshot)
    assert saved["gen_state"]["model"]["prelude.fc.weight"].shape == (512, 128)
    assert saved["pos_state"]["model"]["w1.weight"].shape == (1024, 32)
    assert saved["d3d_state"]["opt"]["state"][0]["exp_avg"].shape == (512, 30)
    resumed = run_fk_gan.main(TINY_WIDE + ["--epochs", "3", "--resume", snapshot,
                                           "--checkpoint", str(tmp_path / "one")])
    assert len(resumed["epoch_seconds"]) == 1
    assert all(np.isfinite(v) for v in resumed["scores"]["h36m"].values())


def test_video_cli_trains_on_tp2(tmp_path):
    """Video mode on tp2 through the library launcher: the five GAN nets
    512 wide (the motion critics' towers sharded), the multi-frame
    VideoPose at its CLI-test width (32 channels, narrower than the
    shard's minimum, so whole on both ranks), one epoch with the motion
    critics on, and a ``--ckpt_format orbax`` snapshot."""
    from dhaug_torch.utils.checkpoint import load_snapshot
    argv = ["--single_or_multi_train_mode", "multi", "--posenet_name", "mulit_farme_videopose",
            "--architecture", "3,3", "--batch_size", "64", "--downsample", "16",
            "--warmup", "0", "--additional_train_epoch", "0", "--epochs", "1",
            "--single_dis_warmup_epoch", "0", *WIDE, "--video_Dis_DenseDim_3D", "512",
            "--video_Dis_DenseDim_2D", "512", "--data_root", REPO, "--device", "cpu",
            "--model_parallel_devices", "2", "--ckpt_format", "orbax", "--snapshot", "1",
            "--checkpoint", str(tmp_path)]
    out = mesh.launch("test_torch_tp_worker:narrow_video_cli", (argv,), ["cpu", "cpu"], "gloo",
                      threads=1, model_parallel=2)
    result = out[0]
    assert out[1] == {"launches": {"fwd": 0, "bwd": 0, "trunk": 0}}
    assert all(np.isfinite(v) for v in result["scores"]["h36m"].values())
    assert all(np.isfinite(v) for vals in result["epoch_scalars"].values() for v in vals)
    assert len(result["epoch_scalars"]["motion_Fk_d3d_Wasserstein_D"]) == 1
    saved = load_snapshot(os.path.join(result["run_dir"], "ckpt_resume_latest"))
    assert saved["md3d_state"]["model"]["kcs_tower.prelude.fc.weight"].shape == (512, 135)


def test_baseline_cli_on_a_2x2_grid_trains_like_one_process(tmp_path):
    """``run_baseline --data_parallel_devices 2 --model_parallel_devices 2``
    (four ranks: the MLP's 1024-wide layers split in two, each half
    trained on two data rows) against one process, as
    tests/test_torch_parallel.py holds two data ranks: the best H36M/3DHP
    P1 within 0.05 mm, and only global rank 0 writes."""
    from dhaug_torch import run_baseline
    base = ["--posenet_name", "mlp", "--stages", "1", "--batch_size", "512", "--lr", "1e-4",
            "--epochs", "1", "--data_root", REPO, "--device", "cpu"]
    one = run_baseline.main(base + ["--checkpoint", str(tmp_path / "one")])
    grid = mesh.launch_main("dhaug_torch.run_baseline",
                            base + ["--checkpoint", str(tmp_path / "grid"),
                                    "--data_parallel_devices", "2",
                                    "--model_parallel_devices", "2"],
                            ["cpu"] * 4, "gloo", threads=1, model_parallel=2)
    assert grid["rank_launches"] == [{"fwd": 0, "bwd": 0, "trunk": 0}] * 4
    assert sorted(os.listdir(grid["run_dir"])) == sorted(os.listdir(one["run_dir"]))
    assert len(os.listdir(os.path.join(str(tmp_path), "grid", "mlp", "gt"))) == 1
    for key in ("best_h36m", "best_dhp"):
        assert np.isfinite(grid[key]) and abs(grid[key] - one[key]) <= 0.05, (key, grid, one)
