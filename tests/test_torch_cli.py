"""The slice as a whole: ``python -m dhaug_torch.run_fk_gan`` on the CPU at
tiny widths on the repo's fixtures (the MLP with the GAN; gcn and videopose
with the GAN; the normal and NO_enhance modes; ``--pretrain``; video mode
with both multi-frame posenets, its resume and ``run_evaluate`` on its
checkpoints), the package's independence from JAX, and ``chip_smoke.py``'s
refusals without the package or a card."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--posenet_name", "mlp", "--lr_p", "1e-3", "--keypoints", "gt",
        "--batch_size", "512", "--data_enhancement_method", "GAN",
        "--single_or_multi_train_mode", "single", "--epochs", "2",
        "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
        "--Gen_DenseDim", "32", "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32",
        "--data_root", REPO]


def _env():
    """The subprocesses run one OpenMP/MKL thread: under a parallel test run
    torch's default of one thread a core oversubscribes the cores."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def test_two_epoch_cpu_run_writes_the_jax_log_schema(tmp_path):
    code = (
        "import json, sys\n"
        "from dhaug_torch import run_fk_gan\n"
        "from dhaug_torch.ops import fk_cuda\n"
        "out = run_fk_gan.main(sys.argv[1:])\n"
        "print(json.dumps({'launches': [fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES],\n"
        "                  'run_dir': out['run_dir'], 'scores': out['scores'],\n"
        "                  'scalars': out['epoch_scalars']}))\n")
    proc = subprocess.run([sys.executable, "-c", code, *TINY, "--device", "cpu",
                           "--checkpoint", str(tmp_path)],
                          capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["launches"] == [0, 0]  # the CPU never reaches the kernels
    for scores in result["scores"].values():
        assert all(np.isfinite(v) and v > 0 for v in scores.values())
    assert len(result["scalars"]["3d_wasserstein"]) == 2

    log = open(os.path.join(result["run_dir"], "log.txt")).read().splitlines()
    header = log.index("epoch\tlr\terror_h36m_p1\terror_h36m_p2\terror_3dhp_p1\t"
                       "error_3dhp_p2\tPCK\tAUC")
    # data rows; "==> Saving checkpoint ..." lines record the best saves
    rows = [line.split("\t") for line in log[header + 1:] if not line.startswith("==>")]
    # epoch 0 (warmup 0 -> no posenet pass yet), epoch 1 '_fake' + final rows
    assert [r[0] for r in rows] == ["0", "1", "1"]
    assert any(line.startswith("==> Saving checkpoint at epoch '1'") for line in log)
    assert all(len(r) == 8 for r in rows)
    assert all(np.isfinite(float(v)) for v in rows[-1])
    assert float(rows[-1][2]) > 0
    metrics = open(os.path.join(result["run_dir"], "metrics.jsonl")).read()
    assert "train_G_iter_PoseFk/Fk_d3d_Wasserstein_D" in metrics
    assert "posenet_mpi3d_loader_flip/p1score_real" in metrics


def test_no_jax_in_the_port():
    """Importing every dhaug_torch module (and chip_smoke.py) loads no jax,
    flax, optax or dhaug_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dhaug_torch\n"
        "for m in pkgutil.walk_packages(dhaug_torch.__path__, 'dhaug_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'dhaug_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('dhaug_torch.')]), bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(), cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules, bad = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert bad == "[]"
    assert int(n_modules) >= 65


def test_chip_smoke_alone_refuses_with_rc_2(tmp_path):
    """``chip_smoke.py`` in a directory that holds nothing else of the repo
    exits 2, naming the missing package, and prints no result."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          cwd=tmp_path, timeout=60)
    assert proc.returncode == 2
    assert "the dhaug_torch package is not beside this script" in proc.stderr
    assert proc.stdout == ""


def test_chip_smoke_without_a_card_exits_1():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          env=_env(), cwd=REPO, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_device_cuda_without_a_card_raises():
    import torch

    from dhaug_torch import run_fk_gan
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fk_gan.main(TINY + ["--device", "cuda"])


def test_parser_keeps_every_reference_flag_and_default():
    from dhaug_torch.train.config import get_aug_parser as torch_parser
    from dhaug_tpu.train.config import get_aug_parser as jax_parser

    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    t, j = flags(torch_parser()), flags(jax_parser())
    assert set(j) - set(t) == {"jax_platform"}
    assert set(t) - set(j) == {"device"}
    assert t["device"] == "cuda"
    assert {k: v for k, v in t.items() if k != "device"} == \
        {k: v for k, v in j.items() if k != "jax_platform"}


@pytest.mark.parametrize("extra", [[], ["--downsample", "3", "--actions", "Walking"]])
def test_prepare_data_matches_jax(extra):
    from dhaug_torch.train.config import parse_aug_args as torch_args
    from dhaug_torch.train.data_prep import prepare_data as torch_prepare
    from dhaug_tpu.train.config import parse_aug_args as jax_args
    from dhaug_tpu.train.data_prep import prepare_data as jax_prepare

    argv = ["--data_root", REPO] + extra
    t, j = torch_prepare(torch_args(argv)), jax_prepare(jax_args(argv))
    for name in ("train_det2d3d", "train_gt2d3d", "h36m_test"):
        for field in ("poses_3d", "poses_2d", "cams"):
            np.testing.assert_array_equal(getattr(getattr(t, name), field),
                                          getattr(getattr(j, name), field),
                                          err_msg=f"{name}.{field}")
    np.testing.assert_array_equal(t.mpi3d.poses_3d, j.mpi3d.poses_3d)
    np.testing.assert_array_equal(t.mpi3d.poses_2d, j.mpi3d.poses_2d)


# tiny in-process epochs: 1200 training frames (--downsample 4) in batches
# of 256, so 4 GAN iterations an epoch
SMALL = ["--lr_p", "1e-3", "--keypoints", "gt", "--batch_size", "256", "--downsample", "4",
         "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
         "--Gen_DenseDim", "32", "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32",
         "--data_root", REPO, "--device", "cpu"]


@pytest.fixture
def one_intra_op_thread():
    """In-process runs are too small to gain from torch's intra-op threads;
    under a parallel test run those threads oversubscribe the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags,fake_pass", [
    (["--posenet_name", "gcn", "--epochs", "2"], True),
    (["--posenet_name", "videopose", "--epochs", "2"], True),
    (["--data_enhancement_method", "normal", "--generator_whole_number", "64",
      "--posenet_name", "mlp", "--epochs", "1"], True),
    (["--data_enhancement_method", "NO_enhance", "--posenet_name", "gcn", "--epochs", "1"],
     False),
], ids=["gcn", "videopose", "normal", "NO_enhance"])
def test_tiny_epochs_of_every_single_frame_posenet_and_mode(flags, fake_pass, tmp_path,
                                                            one_intra_op_thread):
    from dhaug_torch import run_fk_gan
    out = run_fk_gan.main(SMALL + flags + ["--checkpoint", str(tmp_path)])
    for scores in out["scores"].values():
        assert all(np.isfinite(v) and v > 0 for v in scores.values())
    assert (out["gan"] is not None) == ("--data_enhancement_method" not in flags)
    assert type(out["posenet"]).__name__ == {
        "gcn": "SemGCN", "videopose": "TemporalPoseNet", "mlp": "LinearModel"}[flags[
            flags.index("--posenet_name") + 1]]
    log = open(os.path.join(out["run_dir"], "log.txt")).read().splitlines()
    rows = log[log.index("epoch\tlr\terror_h36m_p1\terror_h36m_p2\terror_3dhp_p1\t"
                         "error_3dhp_p2\tPCK\tAUC") + 1:]
    rows = [r for r in rows if not r.startswith("==>")]
    # a '_fake' row after each posenet pass on fakes, then the epoch's row
    last_epoch = str(len(out["epoch_seconds"]) - 1)
    assert [r.split("\t")[0] for r in rows].count(last_epoch) == (2 if fake_pass else 1)
    for name in ("ckpt_best_dhp_p1.ckpt", "ckpt_best_h36m_p1.ckpt"):
        assert os.path.isfile(os.path.join(out["run_dir"], name))


def test_pretrain_evaluates_the_checkpoint_and_trains_nothing(tmp_path, one_intra_op_thread):
    import torch

    from dhaug_torch import run_evaluate, run_fk_gan
    from dhaug_torch.models.factory import make_posenet
    from dhaug_torch.utils.checkpoint import save_ckpt
    torch.manual_seed(0)
    path = save_ckpt({"model_pos": make_posenet("mlp", stages=1).state_dict(),
                      "posenet_name": "mlp"}, str(tmp_path), suffix="best_h36m_p1")
    got = run_fk_gan.main(SMALL + ["--posenet_name", "mlp", "--pretrain", "true",
                                   "--evaluate", path, "--checkpoint", str(tmp_path / "runs")])
    want = run_evaluate.main(["--evaluate", path, "--stages", "1", "--batch_size", "256",
                              "--downsample", "4", "--data_root", REPO, "--device", "cpu"])
    assert got["h36m"] == want["h36m"] and got["dhp"] == want["dhp"]
    assert not (tmp_path / "runs").exists()  # no run directory: nothing trained


# video mode: 600 training frames (--downsample 8) in batches of 64, so 9
# GAN iterations an epoch; the generator and critics 48 wide and, through
# narrow_video_posenets, 32-channel VideoPose and a one-block PoseFormer
VIDEO = ["--single_or_multi_train_mode", "multi", "--architecture", "3,3", "--batch_size", "64",
         "--downsample", "8", "--warmup", "0", "--additional_train_epoch", "0",
         "--Gen_DenseDim", "48", "--Dis_DenseDim_3D", "48", "--Dis_DenseDim_2D", "48",
         "--video_Dis_DenseDim_3D", "48", "--video_Dis_DenseDim_2D", "48",
         "--data_root", REPO, "--device", "cpu"]


def _narrow_posenet(name, *, stages=4, dropout=0.25, architecture="3,3,3", skeleton=None,
                    flag="train"):
    """The multi-frame posenets of models/factory.make_posenet at CPU-test
    widths (the full ones take minutes an epoch on the CPU)."""
    from dhaug_torch.models.factory import receptive_field
    from dhaug_torch.models.posenets import PoseFormer, TemporalPoseNet
    if name == "mulit_farme_videopose":
        return TemporalPoseNet([int(w) for w in architecture.split(",")], out_joints=16,
                               channels=32, strided=flag == "train")
    assert name == "mulit_farme_poseformer", name
    return PoseFormer(num_frame=receptive_field(architecture), embed_dim_ratio=8, depth=1,
                      num_heads=2, drop_path_rate=0.1 if flag == "train" else 0.0)


@pytest.fixture(scope="module")
def narrow_video_posenets():
    from dhaug_torch import run_evaluate
    from dhaug_torch.train import video_runner
    import torch
    mp = pytest.MonkeyPatch()
    mp.setattr(video_runner, "make_posenet", _narrow_posenet)
    mp.setattr(run_evaluate, "make_posenet", _narrow_posenet)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    mp.undo()


@pytest.fixture(scope="module")
def video_run(narrow_video_posenets, tmp_path_factory):
    """3 epochs of mulit_farme_videopose: the motion critics from epoch 1,
    the posenet from epoch 2; a snapshot after epoch 1."""
    from dhaug_torch import run_fk_gan
    return run_fk_gan.main(VIDEO + ["--posenet_name", "mulit_farme_videopose", "--epochs", "2",
                                    "--single_dis_warmup_epoch", "1", "--snapshot", "2",
                                    "--checkpoint", str(tmp_path_factory.mktemp("video"))])


def _log_rows(run_dir):
    log = open(os.path.join(run_dir, "log.txt")).read().splitlines()
    rows = log[log.index("epoch\tlr\terror_h36m_p1\terror_h36m_p2\terror_3dhp_p1\t"
                         "error_3dhp_p2\tPCK\tAUC") + 1:]
    return [r.split("\t") for r in rows if not r.startswith("==>")]


def test_video_mode_run_trains_evaluates_and_consumes_the_numpy_stream_alike(video_run):
    """Scores, log rows, checkpoints, the scalar tags (motion ones from
    epoch 1) and the numpy stream: each epoch one template index a training
    sequence and the clip loader's seed, then, in the trained epoch, the
    fake pass's permutation and the real pass's (the JAX package's order)."""
    out = video_run
    for scores in out["scores"].values():
        assert all(np.isfinite(v) and v > 0 for v in scores.values())
    assert [r[0] for r in _log_rows(out["run_dir"])] == ["0", "1", "2", "2"]
    for name in ("ckpt_best_dhp_p1.ckpt", "ckpt_best_h36m_p1.ckpt", "ckpt_resume_latest.ckpt"):
        assert os.path.isfile(os.path.join(out["run_dir"], name))
    scalars = out["epoch_scalars"]
    assert len(scalars["Fk_d3d_Wasserstein_D"]) == 3 and len(scalars["G_cost"]) == 3
    assert len(scalars["motion_Fk_d3d_Wasserstein_D"]) == 2
    assert len(scalars["motion_d2d_Wasserstein_D"]) == 2
    assert all(np.isfinite(v) for vals in scalars.values() for v in vals)
    metrics = open(os.path.join(out["run_dir"], "metrics.jsonl")).read()
    assert "train_G_iter_PoseFk/motion_Fk_d3d_Wasserstein_D" in metrics
    assert "posenet_H36M_test/p1score_fake" in metrics

    templates = np.load(os.path.join(REPO, "data_extra", "bone_length_npy",
                                     "hm36s15678_bl_templates.npy"))
    mirror = np.random.default_rng(0)
    n_frames, n_seq, batch = 600, 40, 64
    for epoch in range(3):
        for _ in range(n_seq):
            mirror.integers(0, templates.shape[0])
        mirror.integers(0, 2 ** 31)
        if epoch == 2:
            mirror.permutation(n_frames // batch * batch)    # the fake clips
            mirror.permutation(n_frames)                     # the real windows
    assert out["np_rng"].bit_generator.state == mirror.bit_generator.state


def test_video_mode_stop_and_resume_is_bit_identical(video_run, tmp_path):
    import torch

    from dhaug_torch import run_fk_gan
    from dhaug_torch.utils.checkpoint import load_snapshot
    a = video_run
    snapshot = os.path.join(a["run_dir"], "ckpt_resume_latest.ckpt")
    saved = load_snapshot(snapshot)
    assert saved["epoch"] == 1 and saved["trained_epochs"] == 0
    assert {"pos_state", "gen_state", "d3d_state", "d2d_state", "md3d_state", "md2d_state",
            "summary", "np_rng", "torch_rng"} <= set(saved)
    b = run_fk_gan.main(VIDEO + ["--posenet_name", "mulit_farme_videopose", "--epochs", "2",
                                 "--single_dis_warmup_epoch", "1", "--snapshot", "2",
                                 "--checkpoint", str(tmp_path), "--resume", snapshot])
    assert len(b["epoch_seconds"]) == 1
    assert b["scores"] == a["scores"] and b["epoch_scalars"] == a["epoch_scalars"]
    assert b["np_rng"].bit_generator.state == a["np_rng"].bit_generator.state
    assert torch.equal(b["generator"].get_state(), a["generator"].get_state())
    pairs = [("pos", a["posenet"], a["pos_opt"], b["posenet"], b["pos_opt"])]
    for name in ("gen", "d3d", "d2d", "md3d", "md2d"):
        pairs.append((name, getattr(a["gan"], name), getattr(a["gan"], f"{name}_opt"),
                      getattr(b["gan"], name), getattr(b["gan"], f"{name}_opt")))
    for name, net_a, opt_a, net_b, opt_b in pairs:
        for k, v in net_a.state_dict().items():
            assert torch.equal(v, net_b.state_dict()[k]), (name, k)
        sa, sb = opt_a.state_dict()["state"], opt_b.state_dict()["state"]
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]), name


def test_evaluate_reproduces_the_video_runs_best(video_run):
    """run_evaluate on the run's best checkpoint gives the best H36M P1 the
    run saw, and a per-action breakdown."""
    from dhaug_torch import run_evaluate
    ckpt = os.path.join(video_run["run_dir"], "ckpt_best_h36m_p1.ckpt")
    got = run_evaluate.main(["--evaluate", ckpt, "--architecture", "3,3", "--batch_size", "64",
                             "--data_root", REPO, "--device", "cpu"])
    assert got["posenet_name"] == "mulit_farme_videopose"
    assert abs(got["h36m"]["p1"] - video_run["best_h36m"]) <= 1e-3
    assert got["actions"] and all(np.isfinite(v) and v > 0 for v in got["actions"].values())


def test_video_mode_with_poseformer_and_windowed_evaluation(narrow_video_posenets, tmp_path):
    """2 epochs of mulit_farme_poseformer, motion critics from epoch 0 and
    the posenet in epoch 1; its evaluation runs on centre-frame windows,
    and run_evaluate on its checkpoint gives the run's best H36M P1."""
    from dhaug_torch import run_evaluate, run_fk_gan
    out = run_fk_gan.main(VIDEO + ["--posenet_name", "mulit_farme_poseformer", "--epochs", "2",
                                   "--single_dis_warmup_epoch", "0",
                                   "--checkpoint", str(tmp_path)])
    for scores in out["scores"].values():
        assert all(np.isfinite(v) and v > 0 for v in scores.values())
    assert type(out["posenet"]).__name__ == "PoseFormer"
    assert len(out["epoch_scalars"]["motion_d2d_Wasserstein_D"]) == 2
    assert [r[0] for r in _log_rows(out["run_dir"])] == ["0", "1", "1"]
    ckpt = os.path.join(out["run_dir"], "ckpt_best_h36m_p1.ckpt")
    got = run_evaluate.main(["--evaluate", ckpt, "--architecture", "3,3", "--batch_size", "64",
                             "--action-wise", "false", "--data_root", REPO, "--device", "cpu"])
    assert abs(got["h36m"]["p1"] - out["best_h36m"]) <= 1e-3


@pytest.mark.parametrize("flags", [["--posenet_name", "mulit_farme_videopose"],
                                   ["--single_or_multi_train_mode", "multi"]],
                         ids=["video_net_single_mode", "frame_net_multi_mode"])
def test_posenet_and_mode_must_agree(flags):
    from dhaug_torch import run_fk_gan
    with pytest.raises(SystemExit, match="needs --single_or_multi_train_mode"):
        run_fk_gan.main(TINY + ["--device", "cpu"] + flags)
