"""The JAX package's posenet checkpoints in the port (utils/checkpoint.py)
and 3DPW scoring of video checkpoints (run_evaluate.py), on the CPU.

Each of the five posenets, at narrow width in both packages, is saved by
the JAX package's ``save_ckpt`` in one of its layouts ('state_dict' from
``run_baseline.py``, 'model_pos' from ``run_Fk_GAN.py``), then scored by the
JAX ``run_evaluate`` and by the port's: H36M and 3DHP P1/P2 agree to
1e-3 mm.  The video checkpoints are also scored on a 3DPW-style npz whose
frame count is not a multiple of ``--batch_size``, with 24-joint (SMPL)
and 16-joint ground truth: P1/P2 to 1e-3 mm (the JAX CLI prints its 3DPW
score only, so its full-precision values are read off its metric calls).
A pickle naming any global other than numpy's array machinery is refused
before anything of it runs."""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import run_evaluate as jax_evaluate
from dhaug_torch import run_baseline, run_evaluate
from dhaug_torch.models import factory as t_factory
from dhaug_torch.models import posenets as t_pose
from dhaug_torch.utils.checkpoint import load_posenet_checkpoint
from dhaug_tpu.models import factory as j_factory
from dhaug_tpu.models import posenets as j_pose
from dhaug_tpu.ops import metrics as j_metrics
from dhaug_tpu.utils.checkpoint import save_ckpt as jax_save_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_MM = 1e-3
BATCH = 32
ARGS = ["--data_root", REPO, "--batch_size", str(BATCH), "--architecture", "3",
        "--action-wise", "false"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _widths(architecture):
    return tuple(int(w) for w in architecture.split(","))


def _jax_narrow(name, *, stages=4, dropout=0.25, architecture="3,3,3", skeleton=None,
                flag="train"):
    """models/factory.make_posenet of the JAX package at test widths."""
    if name == "mlp":
        return j_pose.LinearModel(linear_size=48, num_stage=2, dropout=dropout)
    if name == "gcn":
        return j_pose.SemGCN(adj=j_factory.adjacency_from_skeleton(skeleton), hid_dim=24,
                             num_layers=2, dropout=dropout)
    if name == "videopose":
        return j_pose.TemporalPoseNet(filter_widths=(1, 1, 1), out_joints=15,
                                      pad_hip_joint=True, channels=40, strided=True)
    if name == "mulit_farme_videopose":
        return j_pose.TemporalPoseNet(filter_widths=_widths(architecture), out_joints=16,
                                      channels=40, strided=flag == "train")
    return j_pose.PoseFormer(num_frame=int(np.prod(_widths(architecture))),
                             embed_dim_ratio=16, depth=2, num_heads=4, drop_path_rate=0.0)


def _torch_narrow(name, *, stages=4, dropout=0.25, architecture="3,3,3", skeleton=None,
                  flag="train"):
    """The port's counterpart of _jax_narrow."""
    if name == "mlp":
        return t_pose.LinearModel(linear_size=48, num_stage=2, p_dropout=dropout)
    if name == "gcn":
        return t_pose.SemGCN(t_factory.adjacency_from_skeleton(skeleton), hid_dim=24,
                             num_layers=2, p_dropout=dropout)
    if name == "videopose":
        return t_pose.TemporalPoseNet((1, 1, 1), out_joints=15, pad_hip_joint=True,
                                      channels=40, strided=True)
    if name == "mulit_farme_videopose":
        return t_pose.TemporalPoseNet(_widths(architecture), out_joints=16, channels=40,
                                      strided=flag == "train")
    return t_pose.PoseFormer(num_frame=int(np.prod(_widths(architecture))), embed_dim_ratio=16,
                             depth=2, num_heads=4, drop_path_rate=0.0)


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(j_factory, "make_posenet", _jax_narrow)
    mp.setattr(run_evaluate, "make_posenet", _torch_narrow)
    mp.setattr(run_baseline, "make_posenet", _torch_narrow)
    yield tmp_path_factory.mktemp("jax_ckpts")
    mp.undo()


def _jax_checkpoint(name, layout, out_dir):
    """A JAX checkpoint of the narrow ``name`` net: its initial parameters
    perturbed by seeded noise, BatchNorm statistics moved off 0 and 1."""
    from dhaug_tpu.data.h36m import Human36mDataset
    skeleton = Human36mDataset(os.path.join(REPO, "data", "data_3d_h36m.npz")).skeleton()
    model = _jax_narrow(name, architecture="3", skeleton=skeleton)
    example = np.zeros((2, 16, 2) if name in ("mlp", "gcn", "videopose") else (2, 3, 16, 2),
                       np.float32)
    params, stats = j_factory.init_posenet(model, jax.random.PRNGKey(0), example)
    rng = np.random.default_rng(len(name))
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape)
                          .astype(np.float32), params)
    stats = jax.tree.map(lambda s: np.asarray(s) * rng.uniform(0.5, 1.5, s.shape)
                         .astype(np.float32) + 0.01, stats)
    ckpt = {"epoch": 3, layout: params, "batch_stats": stats, "posenet_name": name}
    if layout == "state_dict":   # run_baseline.py's keys
        ckpt.update(lr=1e-3, error=float(rng.uniform(40, 80)))
    return jax_save_ckpt(ckpt, str(out_dir), suffix=f"{name}_{layout}")


def _pw3d(path, joints, n=70):
    rng = np.random.default_rng(joints)
    np.savez(path, pose3d=rng.normal(size=(n, joints, 3)).astype(np.float32) * 0.3,
             pose2d=rng.normal(size=(n, 16, 2)).astype(np.float32) * 0.3)
    return str(path)


def _jax_scores(argv, monkeypatch):
    """The JAX run_evaluate's H36M/3DHP scores and, where asked, its 3DPW
    P1/P2 at full precision: the last mpjpe/p_mpjpe values it computes."""
    seen = {"mpjpe": [], "p_mpjpe": []}
    for fn in seen:
        orig = getattr(j_metrics, fn)
        monkeypatch.setattr(j_metrics, fn, lambda *a, _f=orig, _k=fn:
                            seen[_k].append(float(_f(*a))) or _f(*a))
    h36m, dhp = jax_evaluate.main(argv)
    pw3d = {"p1": seen["mpjpe"][-1] * 1000.0, "p2": seen["p_mpjpe"][-1] * 1000.0} \
        if "--Path_3DPW" in argv else None
    return h36m, dhp, pw3d


def _assert_scores_match(got, want, keys=("p1", "p2")):
    for k in keys:
        assert abs(got[k] - want[k]) <= TOL_MM, (k, got[k], want[k])


@pytest.mark.parametrize("name,layout,joints", [
    ("mlp", "state_dict", None), ("gcn", "model_pos", None), ("videopose", "state_dict", None),
    ("mulit_farme_videopose", "model_pos", 24), ("mulit_farme_videopose", "state_dict", 16),
    ("mulit_farme_poseformer", "model_pos", 24), ("mulit_farme_poseformer", "state_dict", 16)])
def test_jax_checkpoint_scores_as_in_jax(name, layout, joints, narrow, tmp_path, monkeypatch):
    path = _jax_checkpoint(name, layout, narrow)
    argv = ["--evaluate", path] + ARGS
    if joints:
        argv += ["--Path_3DPW", _pw3d(tmp_path / "pw3d.npz", joints)]
    h36m, dhp, pw3d = _jax_scores(argv, monkeypatch)
    got = run_evaluate.main(argv + ["--device", "cpu"])
    assert got["posenet_name"] == name
    _assert_scores_match(got["h36m"], h36m)
    _assert_scores_match(got["dhp"], dhp)
    if joints:
        assert got["pw3d"]["joints"] == (14 if joints == 24 else 16)
        assert got["pw3d"]["frames"] == 70 and 70 % BATCH
        _assert_scores_match(got["pw3d"], pw3d)


def test_pretrain_warm_starts_from_a_jax_checkpoint(narrow, tmp_path):
    """run_baseline --pretrain on a JAX 'state_dict' checkpoint: at --lr 0
    Adam moves nothing, so the trained net keeps the checkpoint's weights
    (its BatchNorm statistics move in the epoch's train-mode passes)."""
    from dhaug_torch.data.h36m import Human36mDataset
    from dhaug_torch.models.convert import load_posenet
    path = _jax_checkpoint("gcn", "state_dict", narrow)
    out = run_baseline.main(["--posenet_name", "gcn", "--epochs", "1", "--lr", "0",
                             "--pretrain", "true", "--evaluate", path, "--device", "cpu",
                             "--checkpoint", str(tmp_path), "--data_root", REPO,
                             "--batch_size", "512"])
    saved = load_posenet_checkpoint(path)
    skeleton = Human36mDataset(os.path.join(REPO, "data", "data_3d_h36m.npz")).skeleton()
    want = load_posenet("gcn", _torch_narrow("gcn", skeleton=skeleton), saved["state_dict"],
                        saved["batch_stats"])
    got = dict(out["posenet"].named_parameters())
    for k, v in want.named_parameters():
        assert torch.equal(got[k].detach(), v.detach()), k


class _Marker:
    """Unpickling this would create the file ``path``."""

    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (open, (self.path, "w"))


def test_a_pickle_with_other_globals_is_refused_unrun(tmp_path):
    marker = tmp_path / "ran"
    path = tmp_path / "ckpt_best.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"model_pos": {"w": np.zeros(3)}, "x": _Marker(str(marker))}, f)
    with pytest.raises(pickle.UnpicklingError, match=r"refused to unpickle the global _?io\.open"):
        run_evaluate.main(["--evaluate", str(path), "--device", "cpu", "--data_root", REPO])
    assert not marker.exists()


def test_resume_refuses_a_jax_checkpoint(narrow):
    """--resume takes the port's own snapshots only: a JAX package pickle is
    refused with a message that says so, before any training."""
    from dhaug_torch import run_fk_gan
    path = _jax_checkpoint("mlp", "model_pos", narrow)
    with pytest.raises(NotImplementedError, match="is a JAX package checkpoint"):
        run_fk_gan.main(["--posenet_name", "mlp", "--stages", "1", "--batch_size", "512",
                         "--Gen_DenseDim", "32", "--Dis_DenseDim_3D", "32",
                         "--Dis_DenseDim_2D", "32", "--data_root", REPO, "--device", "cpu",
                         "--checkpoint", str(narrow / "runs"), "--resume", path])
