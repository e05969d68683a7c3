"""``python -m dhaug_torch.run_baseline`` and ``run_evaluate`` on the CPU at
small sizes, with the pieces they use held to the JAX package: the
step-decayed schedule, the baseline parser, the metrics, the 3DPW tables,
and the checkpoint layouts evaluate reads."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch import run_baseline, run_evaluate, synthesize_dataset
from dhaug_torch.data import pw3d as t_pw3d
from dhaug_torch.models.factory import make_posenet
from dhaug_torch.ops import metrics as t_metrics
from dhaug_torch.train import state as t_state
from dhaug_torch.train.config import parse_baseline_args
from dhaug_torch.train.data_prep import prepare_data
from dhaug_torch.train.posenet import evaluate_both
from dhaug_torch.utils.checkpoint import load_ckpt, save_ckpt
from dhaug_tpu.data import pw3d as j_pw3d
from dhaug_tpu.ops import metrics as j_metrics
from dhaug_tpu.train import state as j_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--posenet_name", "mlp", "--stages", "1", "--batch_size", "512",
         "--data_root", REPO, "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """One epoch of the MLP baseline."""
    return run_baseline.main(SMALL + ["--epochs", "1",
                                      "--checkpoint", str(tmp_path_factory.mktemp("base"))])


@pytest.fixture(scope="module")
def synth_npz(tmp_path_factory):
    """A small dataset from the port's own synthesis CLI."""
    out = tmp_path_factory.mktemp("synth") / "synth.npz"
    synthesize_dataset.main(["--device", "cpu", "--random_init", "true", "--Gen_DenseDim", "32",
                             "--n_poses", "600", "--batch", "200", "--out", str(out)])
    return str(out)


@pytest.mark.parametrize("step,decay,gamma", [(0, 100000, 0.96), (250000, 100000, 0.96),
                                              (7, 3, 0.5)])
def test_schedules_match_jax(step, decay, gamma):
    assert t_state.step_exp_lr(1e-3, step, decay, gamma) == \
        j_state.step_exp_lr(1e-3, step, decay, gamma)
    assert t_state.step_lr(1e-3, step, decay, gamma) == j_state.step_lr(1e-3, step, decay, gamma)


def test_baseline_parser_keeps_every_reference_flag_and_default():
    from dhaug_torch.train.config import get_baseline_parser as torch_parser
    from dhaug_tpu.train.config import get_baseline_parser as jax_parser

    def flags(parser):
        return {a.dest: (a.default, getattr(a, "choices", None))
                for a in parser._actions if a.dest != "help"}

    t, j = flags(torch_parser()), flags(jax_parser())
    assert set(j) - set(t) == {"jax_platform"}
    assert set(t) - set(j) == {"device"}
    assert t["device"][0] == "cuda"
    assert {k: v for k, v in t.items() if k != "device"} == \
        {k: v for k, v in j.items() if k != "jax_platform"}


@pytest.mark.parametrize("name", ["p_mpjpe", "n_mpjpe", "mean_velocity_error", "compute_pck",
                                  "compute_auc"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(40, 16, 3)) * 0.3).astype(np.float32)
    b = a + (rng.normal(size=a.shape) * 0.08).astype(np.float32)
    got = float(getattr(t_metrics, name)(torch.from_numpy(a), torch.from_numpy(b)))
    ref = float(getattr(j_metrics, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_pw3d_tables_and_converter_match_jax():
    for table in ("PW3D_TO_16POINTS_TABLE", "PW3D_TO_16POINTS_TABLE_FROM_VIBE",
                  "PW3D_TO_16POINTS_TABLE_FROM_COCO"):
        assert getattr(t_pw3d, table) == getattr(j_pw3d, table)
    joints = np.random.default_rng(2).normal(size=(5, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_pw3d.convert_to_16(joints, t_pw3d.PW3D_TO_16POINTS_TABLE),
                                  j_pw3d.convert_to_16(joints, j_pw3d.PW3D_TO_16POINTS_TABLE))


def test_evaluate_reproduces_the_baselines_best(baseline, tmp_path):
    """One CPU epoch of run_baseline, then run_evaluate on ckpt_best.ckpt:
    the same best H36M P1 within 0.05 mm; 3DPW on a fake SMPL-24 npz."""
    run_dir = baseline["run_dir"]
    assert sorted(f for f in os.listdir(run_dir) if f.startswith("ckpt_")) == \
        ["ckpt_best.ckpt", "ckpt_best_dhp_p1.ckpt"]
    saved = load_ckpt(os.path.join(run_dir, "ckpt_best.ckpt"))
    assert set(saved) == {"epoch", "lr", "error", "state_dict", "posenet_name"}
    log = open(os.path.join(run_dir, "log.txt")).read().splitlines()
    assert "epoch\tlr\terror_h36m_p1\terror_h36m_p2\terror_3dhp_p1\terror_3dhp_p2\tPCK\tAUC" in log

    rng = np.random.default_rng(0)
    pw3d = tmp_path / "fake_3dpw.npz"
    np.savez(pw3d, pose3d=rng.normal(size=(40, 24, 3)).astype(np.float32) * 0.3,
             pose2d=rng.normal(size=(40, 16, 2)).astype(np.float32) * 0.3)
    ev = run_evaluate.main(SMALL + ["--evaluate", os.path.join(run_dir, "ckpt_best.ckpt"),
                                    "--Path_3DPW", str(pw3d)])
    np.testing.assert_allclose(ev["h36m"]["p1"], baseline["best_h36m"], atol=0.05)
    assert ev["pw3d"]["joints"] == 14 and ev["pw3d"]["frames"] == 40
    assert all(np.isfinite(ev["pw3d"][k]) for k in ("p1", "p2"))
    assert set(ev["actions"]) == {"Eating", "Walking"}


@pytest.mark.parametrize("layout", ["state_dict", "model_pos", "pos_state", "pth_state_dict",
                                    "pth_model_pos"])
def test_evaluate_reads_every_checkpoint_layout(layout, tmp_path):
    """A gcn net saved in each layout scores as the net itself does."""
    args = parse_baseline_args(SMALL)
    bundle = prepare_data(args)
    torch.manual_seed(0)
    net = make_posenet("gcn", stages=1, skeleton=bundle.dataset.skeleton())
    net.train()
    with torch.no_grad():  # non-trivial BatchNorm running statistics
        net(torch.from_numpy(bundle.train_det2d3d.poses_2d[:256]))
    want = evaluate_both(net, bundle, 512)
    state = net.state_dict()
    if layout.startswith("pth_"):
        path = str(tmp_path / "ckpt_best.pth.tar")
        torch.save({layout[4:]: state}, path)
    else:
        content = {"pos_state": {"model": state, "opt": {}}} if layout == "pos_state" \
            else {layout: state}
        path = save_ckpt(content, str(tmp_path), suffix="best")
    got = run_evaluate.main(SMALL + ["--posenet_name", "gcn", "--evaluate", path,
                                     "--action-wise", "false"])
    assert (got["h36m"], got["dhp"]) == want


def test_evaluate_names_the_keys_of_a_mismatched_checkpoint(tmp_path):
    path = str(tmp_path / "ckpt.pth.tar")
    torch.save({"model_pos": make_posenet("mlp", stages=1).state_dict()}, path)
    with pytest.raises(ValueError, match="missing.*gconv_input.0.gconv.W.*unexpected.*w1.weight"):
        run_evaluate.main(SMALL + ["--posenet_name", "gcn", "--evaluate", path])


def test_evaluate_refuses_video_checkpoints(tmp_path):
    path = save_ckpt({"model_pos": {}, "posenet_name": "mulit_farme_videopose"},
                     str(tmp_path), suffix="best")
    with pytest.raises(NotImplementedError, match="mulit_farme_videopose"):
        run_evaluate.main(SMALL + ["--evaluate", path])


@pytest.mark.parametrize("mode", ["mix", "replace"])
def test_train_npz_mix_and_replace(mode, synth_npz, tmp_path):
    args = parse_baseline_args(SMALL + ["--train_npz", synth_npz, "--train_npz_mode", mode])
    bundle = prepare_data(args)
    p2d, p3d = run_baseline.training_pairs(args, bundle)
    n_real = bundle.train_det2d3d.poses_2d.shape[0]
    assert p2d.shape == ((n_real if mode == "mix" else 0) + 600, 16, 2)
    assert p3d.shape == (p2d.shape[0], 16, 3)
    synth = np.load(synth_npz)
    np.testing.assert_array_equal(p3d[-600:], synth["pose3d"])
    out = run_baseline.main(SMALL + ["--epochs", "1", "--train_npz", synth_npz,
                                     "--train_npz_mode", mode, "--checkpoint", str(tmp_path)])
    assert np.isfinite(out["best_h36m"]) and np.isfinite(out["best_dhp"])


def test_train_npz_with_too_few_poses_exits(synth_npz, tmp_path):
    with pytest.raises(SystemExit, match="yields only 600 poses < --batch_size 1024"):
        run_baseline.main(SMALL + ["--train_npz", synth_npz, "--train_npz_mode", "replace",
                                   "--batch_size", "1024", "--checkpoint", str(tmp_path)])


def test_pretrain_warm_starts_from_a_checkpoint(baseline, tmp_path):
    """At --lr 0 Adam moves nothing, so after a warm-started epoch the
    parameters are the checkpoint's, bit for bit."""
    src = os.path.join(baseline["run_dir"], "ckpt_best.ckpt")
    pth = str(tmp_path / "ckpt_best.pth.tar")
    torch.save({"state_dict": load_ckpt(src)["state_dict"]}, pth)
    for path in (src, pth):
        out = run_baseline.main(SMALL + ["--epochs", "1", "--lr", "0", "--pretrain", "true",
                                         "--evaluate", path, "--checkpoint", str(tmp_path)])
        saved = load_ckpt(src)["state_dict"]
        for name, p in out["posenet"].named_parameters():
            assert torch.equal(p.detach(), saved[name]), name


@pytest.mark.parametrize("cli", ["run_baseline", "run_fk_gan"])
def test_pretrain_without_evaluate_exits(cli):
    from dhaug_torch import run_fk_gan
    entry = {"run_baseline": run_baseline.main, "run_fk_gan": run_fk_gan.main}[cli]
    with pytest.raises(SystemExit, match="requires --evaluate"):
        entry(["--pretrain", "true", "--posenet_name", "mlp", "--device", "cpu"])


@pytest.mark.parametrize("cli", ["run_baseline", "run_evaluate"])
def test_device_cuda_without_a_card_raises(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    entry = {"run_baseline": run_baseline.main, "run_evaluate": run_evaluate.main}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(["--evaluate", "x.ckpt", "--data_root", REPO, "--device", "cuda"])
