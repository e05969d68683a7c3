"""The port's offline data-prep CLIs (``python -m dhaug_torch.prepare_data_h36m``
and ``prepare_data_3dhp``) against the JAX package's scripts
(``data/prepare_data_h36m.py``, ``data_extra/prepare_data_3dhp.py``) on the
CPU, on the same small inputs: the npz files each side writes, the
refusals, and a data root prepared by the port passing the preflight and
loading for training."""
import contextlib
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dhaug_torch import prepare_data_3dhp as t_3dhp
from dhaug_torch import prepare_data_h36m as t_h36m

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 12
D3 = "data_3d_h36m.npz"
D2 = "data_2d_h36m_gt.npz"
TEST_3DHP = os.path.join("data_extra", "test_set", "test_3dhp.npz")
TEMPLATES = os.path.join("data_extra", "bone_length_npy", "hm36s15678_bl_templates.npy")


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _load(path, key):
    return np.load(path, allow_pickle=True)[key].item()


def _jax_3dhp_script():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_data_3dhp", os.path.join(REPO, "data_extra", "prepare_data_3dhp.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def h36m_runs(tmp_path_factory):
    """tests/test_data.py's tiny .mat export (S1, 2 actions x 12 frames, in
    millimetres) prepared by the JAX script (a subprocess) and by the port's
    CLI (``--device cpu``), each in a directory of its own."""
    import h5py
    work = tmp_path_factory.mktemp("h36m_prep")
    src = work / "source" / "S1" / "MyPoseFeatures" / "D3_Positions"
    src.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for action in ("Walking 1", "Eating"):
        pose = rng.normal(scale=300.0, size=(1, N_FRAMES, 96)) + 1000.0
        with h5py.File(src / f"{action}.mat", "w") as hf:
            hf.create_dataset("data", data=pose.astype(np.float64))
    out = {}
    for side, cmd in (("jax", [os.path.join(REPO, "data", "prepare_data_h36m.py")]),
                      ("port", ["-m", "dhaug_torch.prepare_data_h36m", "--device", "cpu"])):
        out[side] = work / side
        out[side].mkdir()
        proc = subprocess.run([sys.executable, *cmd, "--from-source", str(work / "source")],
                              capture_output=True, text=True, timeout=180, cwd=out[side],
                              env=_env())
        assert proc.returncode == 0, proc.stderr[-2000:]
    return out


def test_h36m_3d_is_bit_for_bit_the_jax_scripts(h36m_runs):
    want = _load(h36m_runs["jax"] / D3, "positions_3d")
    got = _load(h36m_runs["port"] / D3, "positions_3d")
    assert list(got) == list(want) == t_h36m.SUBJECTS
    assert list(got["S1"]) == list(want["S1"]) == ["Eating", "Walking 1"]
    for action, pose in want["S1"].items():
        assert got["S1"][action].dtype == pose.dtype == np.float32
        assert got["S1"][action].shape == (N_FRAMES, 32, 3)
        np.testing.assert_array_equal(got["S1"][action], pose)


def test_h36m_2d_within_a_thousandth_of_a_pixel(h36m_runs):
    """fp32 rounding only (numpy's and torch's quaternion and distortion
    arithmetic differ in operation order): 2.4e-4 px measured on this tree,
    whose pixels reach ~1000 px (one float32 ulp ~6e-5)."""
    want = _load(h36m_runs["jax"] / D2, "positions_2d")
    got = _load(h36m_runs["port"] / D2, "positions_2d")
    assert list(got) == list(want) and list(got["S1"]) == list(want["S1"])
    for action, cams in want["S1"].items():
        assert isinstance(got["S1"][action], list) and len(got["S1"][action]) == 4
        for g, w in zip(got["S1"][action], cams):
            assert g.dtype == np.float32 and g.shape == w.shape == (N_FRAMES, 16, 2)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)


def test_h36m_metadata_equals_the_jax_scripts(h36m_runs):
    want = _load(h36m_runs["jax"] / D2, "metadata")
    assert _load(h36m_runs["port"] / D2, "metadata") == want
    assert want == {"num_joints": 16,
                    "keypoints_symmetry": [[4, 5, 6, 10, 11, 12], [1, 2, 3, 13, 14, 15]]}


def test_h36m_port_files_read_through_both_packages_create_2d_data(h36m_runs):
    from dhaug_torch.data import h36m as t_ds
    from dhaug_torch.data import loaders as t_loaders
    from dhaug_tpu.data import h36m as j_ds
    from dhaug_tpu.data import loaders as j_loaders

    d3, d2 = str(h36m_runs["port"] / D3), str(h36m_runs["port"] / D2)
    got = t_loaders.create_2d_data(d2, t_ds.Human36mDataset(d3))
    want = j_loaders.create_2d_data(d2, j_ds.Human36mDataset(d3))
    for action, cams in want["S1"].items():
        for g, w in zip(got["S1"][action], cams):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
            assert np.abs(g).max() < 2.0   # normalized screen coordinates


def test_h36m_archive_refusal_names_cdflib(tmp_path, monkeypatch):
    archive = tmp_path / "h36m.zip"
    import zipfile
    with zipfile.ZipFile(archive, "w") as zf:
        zf.writestr("S1/MyPoseFeatures/D3_Positions/Walking 1.cdf", b"not read")
    monkeypatch.setitem(sys.modules, "cdflib", None)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as err:
        t_h36m.main(["--from-archive", str(archive), "--device", "cpu"])
    assert "cdflib" in str(err.value.code)
    assert not (tmp_path / "extract_tmp").exists()   # refused before extracting


def test_h36m_mat_refusal_names_h5py(tmp_path):
    code = ("import sys\nsys.modules['h5py'] = None\n"
            "from dhaug_torch import prepare_data_h36m\n"
            f"prepare_data_h36m.main(['--from-source', {str(tmp_path)!r}, '--device', 'cpu'])\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path, env=_env())
    assert proc.returncode != 0
    assert "h5py is required" in proc.stderr
    assert not list(tmp_path.glob("*.npz"))


def test_h36m_without_a_source_exits(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as err:
        t_h36m.main(["--device", "cpu"])
    assert err.value.code == "pass --from-archive or --from-source"
    assert not list(tmp_path.iterdir())


def test_h36m_write_outputs_refuses_a_tensor(tmp_path):
    """A tensor in the pickled dict would make the file unreadable without
    torch."""
    pose = np.zeros((2, 32, 3), np.float32)
    with pytest.raises(TypeError, match=r"positions_2d/S1/Walking\[0\] is a Tensor"):
        t_h36m.write_outputs({"S1": {"Walking": pose}},
                             {"S1": {"Walking": [torch.zeros(2, 16, 2)]}}, str(tmp_path))


def _spin_npz(path, imgname):
    """A SPIN-layout npz of 40 frames: random pixels of 24 joints, some
    unconfident, random 3D with confidences."""
    rng = np.random.default_rng(11)
    n = len(imgname)
    part = np.concatenate([rng.uniform(0, 2048, (n, 24, 2)),
                           (rng.uniform(size=(n, 24, 1)) > 0.2).astype(np.float64)], -1)
    S = np.concatenate([rng.normal(size=(n, 24, 3)), np.ones((n, 24, 1))], -1)
    np.savez(path, imgname=imgname, part=part, S=S)


def _names(n, as_bytes=False):
    names = [f"mpi_inf_3dhp_test_set/TS{1 + i % 6}/imageSequence/img_{i:06d}.jpg"
             for i in range(n)]
    return np.array([s.encode() for s in names] if as_bytes else names)


def _generic_npz(path, dtype):
    rng = np.random.default_rng(12)
    np.savez(path, pose3d=rng.normal(scale=500.0, size=(30, 17, 3)).astype(dtype),
             pose2d=rng.uniform(0, 2048, (30, 17, 2)).astype(dtype))


def _both_3dhp(tmp_path, argv):
    """The JAX script and the port's CLI on ``argv``, each in its own
    directory: the two test_3dhp.npz files."""
    out = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        with contextlib.chdir(tmp_path / side):
            if side == "jax":
                _jax_3dhp_script().main(argv)
            else:
                t_3dhp.main(argv + ["--device", "cpu"])
        out[side] = np.load(tmp_path / side / "test_set" / "test_3dhp.npz")
    return out["jax"], out["port"]


@pytest.mark.parametrize("as_bytes", [False, True], ids=["str_names", "bytes_names"])
def test_3dhp_spin_path_matches_the_jax_script(tmp_path, as_bytes):
    src = tmp_path / "spin.npz"
    _spin_npz(src, _names(40, as_bytes))
    want, got = _both_3dhp(tmp_path, ["--source", str(src)])
    for key in ("pose3d", "pose2d"):
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
    assert np.count_nonzero(got["pose2d"] == 0) > 0       # unconfident joints zeroed


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
def test_3dhp_generic_path_matches_the_jax_script(tmp_path, dtype):
    src = tmp_path / "generic.npz"
    _generic_npz(src, dtype)
    want, got = _both_3dhp(tmp_path, ["--source", str(src), "--res", "1920"])
    for key in ("pose3d", "pose2d"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
    assert np.abs(got["pose3d"][:, 0]).max() == 0.0       # root-centred


def test_committed_3dhp_round_trips_through_a_spin_npz(tmp_path, monkeypatch):
    committed = np.load(os.path.join(REPO, TEST_3DHP))
    names = _names(len(committed["pose3d"]))
    assert any("/TS1/" in s for s in names) and any("/TS5/" in s for s in names)
    np.savez(tmp_path / "spin.npz", **t_3dhp.spin_layout(committed["pose3d"],
                                                         committed["pose2d"], names))
    monkeypatch.chdir(tmp_path)
    result = t_3dhp.main(["--source", str(tmp_path / "spin.npz"), "--device", "cpu"])
    assert result["frames"] == 2929
    got = np.load(tmp_path / "test_set" / "test_3dhp.npz")
    for key in ("pose3d", "pose2d"):
        np.testing.assert_allclose(got[key], committed[key], rtol=0, atol=1e-6)


def test_prepared_root_passes_the_preflight_and_loads(tmp_path, monkeypatch):
    """The committed fixture's 3D as a release-layout .mat tree and its 3DHP
    set as a SPIN npz, prepared by the two CLIs into a fresh data root with
    the bone templates copied in: the port's preflight passes and the
    training data loads (the fixture's 4800 training frames).  The 2D is
    not held to the committed file, whose writer clamps camera depth at
    1 m where the prep script does not."""
    from dhaug_torch.data.validate import validate_dataset_dir
    from dhaug_torch.train.config import parse_aug_args
    from dhaug_torch.train.data_prep import prepare_data

    root = tmp_path / "root"
    (root / "data").mkdir(parents=True)
    positions_3d = _load(os.path.join(REPO, "data", D3), "positions_3d")
    t_h36m.write_mat_tree(positions_3d, str(tmp_path / "release"))
    monkeypatch.chdir(root / "data")
    t_h36m.main(["--from-source", str(tmp_path / "release"), "--device", "cpu"])
    prepared = _load(root / "data" / D3, "positions_3d")
    for subject, actions in positions_3d.items():
        for action, pose in actions.items():
            np.testing.assert_allclose(prepared[subject][action], pose, rtol=0, atol=1e-7)

    committed = np.load(os.path.join(REPO, TEST_3DHP))
    np.savez(tmp_path / "spin.npz", **t_3dhp.spin_layout(
        committed["pose3d"], committed["pose2d"], _names(len(committed["pose3d"]))))
    (root / "data_extra").mkdir()
    monkeypatch.chdir(root / "data_extra")
    t_3dhp.main(["--source", str(tmp_path / "spin.npz"), "--device", "cpu"])
    shutil.copytree(os.path.join(REPO, os.path.dirname(TEMPLATES)),
                    root / os.path.dirname(TEMPLATES))

    report = validate_dataset_dir(str(root), "gt", verbose=False)
    assert report["test_3dhp.npz"] == {"n_frames": 2929}
    bundle = prepare_data(parse_aug_args(["--data_root", str(root)]))
    assert len(bundle.train_gt2d3d) == 4800
    assert np.isfinite(bundle.train_gt2d3d.poses_2d).all()
