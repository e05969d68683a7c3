"""The port's synthetic dataset (dhaug_torch/data/synthetic.py) against the
JAX package's on the CPU: the same numpy stream, the same files to the FK's
fp32 rounding (3D <= 1e-5 m, pixels <= 1e-2, 3DHP 2D <= 1e-5, templates
<= 1e-6 m), at small sizes against the JAX writers and at the defaults
against the committed fixture; only missing files are written; and the
CLIs' ``--synthetic_data true`` (with ``--bf16_trunk true``) in both
modes."""
import os
import shutil

import numpy as np
import pytest
import torch

from dhaug_torch.data import synthetic as t_syn
from dhaug_tpu.data import synthetic as j_syn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"data_3d_h36m.npz/positions_3d": 1e-5, "data_2d_h36m_gt.npz/positions_2d": 1e-2,
       "data_2d_h36m_cpn.npz/positions_2d": 1e-2, "test_3dhp.npz/pose3d": 1e-5,
       "test_3dhp.npz/pose2d": 1e-5, "hm36s15678_bl_templates.npy/lengths": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_random_fk_poses_match_jax_and_consume_the_stream_alike():
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    got = t_syn.random_fk_poses(rng_t, 40, device="cpu")
    want = j_syn.random_fk_poses(rng_j, 40)
    assert got.shape == want.shape == (40, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state


@pytest.fixture(scope="module")
def small_fixtures(tmp_path_factory):
    """Every writer at a small size, in both packages: 8 frames an action,
    64 3DHP frames, 16 templates."""
    roots = {}
    for name, mod, kw in (("jax", j_syn, {}), ("port", t_syn, {"device": "cpu"})):
        root = str(tmp_path_factory.mktemp(name))
        mod.make_h36m_npz(root, n_frames_per_action=8, seed=4, **kw)
        mod.make_det_2d_npz(root, "cpn", seed=7)
        mod.make_3dhp_npz(root, n_frames=64, seed=5, **kw)
        mod.make_bone_templates(root, n_templates=16, seed=6, **kw)
        roots[name] = root
    return roots


@pytest.mark.parametrize("array", sorted(TOL))
def test_each_writer_matches_jax(array, small_fixtures):
    diffs = t_syn.fixture_differences(small_fixtures["port"], small_fixtures["jax"])
    assert set(diffs) == set(TOL)
    assert diffs[array] <= TOL[array], diffs[array]


def test_defaults_write_the_committed_fixture(tmp_path):
    t_syn.ensure_synthetic_dataset(str(tmp_path), device="cpu")
    diffs = t_syn.fixture_differences(str(tmp_path), REPO)
    assert all(diffs[k] <= TOL[k] for k in TOL), diffs


def test_only_missing_files_are_written(tmp_path):
    shutil.copytree(os.path.join(REPO, "data"), tmp_path / "data")
    shutil.copytree(os.path.join(REPO, "data_extra", "test_set"),
                    tmp_path / "data_extra" / "test_set")
    # a file that is present stays as it is, even where it differs from
    # what the writer would put there
    dhp = tmp_path / "data_extra" / "test_set" / "test_3dhp.npz"
    np.savez(dhp, pose3d=np.zeros((3, 16, 3), np.float32), pose2d=np.zeros((3, 16, 2)))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    t_syn.ensure_synthetic_dataset(str(tmp_path), device="cpu")
    assert all(p.read_bytes() == b for p, b in before.items())
    tmpl = os.path.join("data_extra", "bone_length_npy", "hm36s15678_bl_templates.npy")
    np.testing.assert_allclose(np.load(tmp_path / tmpl), np.load(os.path.join(REPO, tmpl)),
                               atol=1e-6, rtol=0)


def test_the_card_is_the_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_syn.ensure_synthetic_dataset(str(tmp_path))
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_cli_synthetic_data_with_the_bf16_trunk(mode, tmp_path, monkeypatch):
    """--synthetic_data true on a directory holding only data/: the port
    writes the 3DHP test set and the templates (the committed ones, to the
    bounds), then trains with --bf16_trunk."""
    from dhaug_torch import run_fk_gan
    from dhaug_torch.train import video_runner
    from test_torch_cli import _narrow_posenet
    monkeypatch.setattr(video_runner, "make_posenet", _narrow_posenet)
    root = tmp_path / "root"
    shutil.copytree(os.path.join(REPO, "data"), root / "data")
    argv = ["--synthetic_data", "true", "--bf16_trunk", "true", "--data_root", str(root),
            "--epochs", "1", "--warmup", "0", "--additional_train_epoch", "0",
            "--single_dis_warmup_epoch", "0", "--stages", "1", "--Gen_DenseDim", "32",
            "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32", "--video_Dis_DenseDim_3D",
            "32", "--video_Dis_DenseDim_2D", "32", "--device", "cpu",
            "--checkpoint", str(tmp_path / "runs")]
    argv += {"single": ["--posenet_name", "mlp", "--batch_size", "256", "--downsample", "4"],
             "multi": ["--posenet_name", "mulit_farme_videopose",
                       "--single_or_multi_train_mode", "multi", "--architecture", "3",
                       "--batch_size", "64", "--downsample", "8"]}[mode]
    out = run_fk_gan.main(argv)
    assert out["gan"].gen.dtype == torch.bfloat16
    assert all(np.isfinite(v) for vals in out["epoch_scalars"].values() for v in vals)
    diffs = t_syn.fixture_differences(str(root), REPO)
    assert all(diffs[k] <= TOL[k] for k in TOL), diffs
