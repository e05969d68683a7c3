"""The port's data preflight (dhaug_torch/data/validate.py and ``python -m
dhaug_torch.validate_data``) against the JAX package's on the CPU: the same
reports for the committed fixture, and for every corruption that
tests/test_validate.py builds the same DataValidationError message (the
two name their own package's fixture writer in one fix hint, and their own
prep scripts)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from dhaug_torch.data import validate as t_val
from dhaug_tpu.data import validate as j_val

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D3 = os.path.join("data", "data_3d_h36m.npz")
D2 = os.path.join("data", "data_2d_h36m_gt.npz")
DHP = os.path.join("data_extra", "test_set", "test_3dhp.npz")
TMPL = os.path.join("data_extra", "bone_length_npy", "hm36s15678_bl_templates.npy")


@pytest.mark.parametrize("keypoints", ["gt", "cpn"])
@pytest.mark.parametrize("require_templates", [True, False])
def test_reports_of_the_committed_fixture_match_jax(keypoints, require_templates):
    kw = dict(keypoints=keypoints, verbose=False, require_templates=require_templates)
    got = t_val.validate_dataset_dir(REPO, **kw)
    assert got == j_val.validate_dataset_dir(REPO, **kw)
    assert got["test_3dhp.npz"] == {"n_frames": 2929}


def _copy_fixture(tmp_path):
    root = tmp_path / "root"
    for sub in ("data", "data_extra"):
        shutil.copytree(os.path.join(REPO, sub), root / sub)
    return root


def _d3(root):
    return np.load(root / D3, allow_pickle=True)["positions_3d"].item()


def _d2(root):
    return np.load(root / D2, allow_pickle=True)["positions_2d"].item()


def _rewrite_3d(root, fn):
    d3 = _d3(root)
    d3["S1"]["Walking 1"] = fn(np.array(d3["S1"]["Walking 1"]))
    np.savez_compressed(root / D3, positions_3d=d3)
    return ("validate_3d_npz", (str(root / D3),))


def _rewrite_2d(root, fn, with_3d=False):
    d2 = _d2(root)
    d2["S1"]["Walking 1"] = [fn(c) for c in d2["S1"]["Walking 1"]]
    np.savez_compressed(root / D2, positions_2d=d2)
    return ("validate_2d_npz", (str(root / D2),) + ((str(root / D3),) if with_3d else ()))


def _rewrite_3dhp(root, fn3d, fn2d):
    src = np.load(root / DHP)
    np.savez(root / DHP, pose3d=fn3d(src["pose3d"]), pose2d=fn2d(src["pose2d"]))
    return ("validate_3dhp_npz", (str(root / DHP),))


def _rewrite_templates(root, scale, with_3d=False):
    np.save(root / TMPL, np.load(root / TMPL) * scale)
    return ("validate_bone_templates", (str(root / TMPL),) + ((str(root / D3),) if with_3d
                                                              else ()))


def _nan_first(pose):
    pose[0, 0, 0] = np.nan
    return pose


def _missing_key(root):
    np.savez(root / D3, wrong_key=np.zeros(3))
    return ("validate_3d_npz", (str(root / D3),))


def _missing_templates(root):
    os.remove(root / TMPL)
    return ("validate_dataset_dir", (str(root), "gt", False, True))


# the JAX package's prep scripts, which its fix hints name, and the port's
# CLIs, which the port's name in their place
PREP_SCRIPTS = {"h36m": ("data/prepare_data_h36m.py", "python -m dhaug_torch.prepare_data_h36m"),
                "3dhp": ("data_extra/prepare_data_3dhp.py",
                         "python -m dhaug_torch.prepare_data_3dhp")}


# each corruption of tests/test_validate.py:39-171, and the part of the
# message that names what is wrong
CORRUPTIONS = {
    "mm_scaled_3d": (lambda r: _rewrite_3d(r, lambda p: p * 1000.0), "MILLIMETRES"),
    "wrong_joint_count_3d": (lambda r: _rewrite_3d(r, lambda p: p[:, :16]), "32-joint"),
    "nan_3d": (lambda r: _rewrite_3d(r, _nan_first), "NaN"),
    "missing_key_3d": (_missing_key, "positions_3d"),
    "17_joint_2d": (lambda r: _rewrite_2d(r, lambda c: np.concatenate([c, c[:, :1]], 1)),
                    "17-joint"),
    "pre_normalized_2d": (lambda r: _rewrite_2d(r, lambda c: c / 500.0 - 1.0), "normalized"),
    "2d_shorter_than_3d": (lambda r: _rewrite_2d(r, lambda c: c[:5], with_3d=True), "frames"),
    "uncentred_3dhp": (lambda r: _rewrite_3dhp(r, lambda p: p + 0.5, lambda p: p),
                       "root-centred"),
    "pixel_2d_3dhp": (lambda r: _rewrite_3dhp(r, lambda p: p, lambda p: p * 1024.0), "PIXEL"),
    "mm_templates": (lambda r: _rewrite_templates(r, 1000.0), "millimetres"),
    "template_data_scale_mismatch": (lambda r: _rewrite_templates(r, 0.25, with_3d=True),
                                     "ratio"),
    "missing_templates": (_missing_templates, "file not found"),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corrupted_files_are_refused_with_the_jax_message(case, tmp_path):
    corrupt, fragment = CORRUPTIONS[case]
    fn, args = corrupt(_copy_fixture(tmp_path))
    messages = []
    for module in (j_val, t_val):
        with pytest.raises(module.DataValidationError) as err:
            getattr(module, fn)(*args)
        messages.append(str(err.value.code).replace("dhaug_tpu.", "dhaug_torch.")
                        .replace(*PREP_SCRIPTS["h36m"]).replace(*PREP_SCRIPTS["3dhp"]))
    assert messages[1] == messages[0]
    assert fragment in messages[1]
    assert isinstance(err.value, SystemExit)


def test_missing_templates_pass_when_not_required(tmp_path):
    root = _copy_fixture(tmp_path)
    os.remove(root / TMPL)
    report = t_val.validate_dataset_dir(str(root), "gt", verbose=False, require_templates=False)
    assert "hm36s15678_bl_templates.npy" not in report
    assert report == j_val.validate_dataset_dir(str(root), "gt", verbose=False,
                                                require_templates=False)


def test_validate_data_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ok = subprocess.run([sys.executable, "-m", "dhaug_torch.validate_data", "--data_root", REPO],
                        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "==> Preflight data validation passed:" in ok.stdout
    root = _copy_fixture(tmp_path)
    _rewrite_3d(root, lambda p: p * 1000.0)
    bad = subprocess.run([sys.executable, "-m", "dhaug_torch.validate_data", "--data_root",
                          str(root)], capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert bad.returncode != 0
    assert "Preflight validation FAILED" in bad.stderr and "MILLIMETRES" in bad.stderr


def test_prepare_data_refuses_a_bad_directory_before_reading_it(tmp_path):
    from dhaug_torch.train.config import parse_aug_args, parse_baseline_args
    from dhaug_torch.train.data_prep import prepare_data
    root = _copy_fixture(tmp_path)
    _rewrite_3d(root, lambda p: p * 1000.0)
    with pytest.raises(t_val.DataValidationError, match="MILLIMETRES"):
        prepare_data(parse_aug_args(["--data_root", str(root)]))
    # the template asset is required by the GAN CLI only
    root2 = _copy_fixture(tmp_path / "b")
    os.remove(root2 / TMPL)
    with pytest.raises(t_val.DataValidationError, match="file not found"):
        prepare_data(parse_aug_args(["--data_root", str(root2)]))
    bundle = prepare_data(parse_baseline_args(["--data_root", str(root2)]))
    assert len(bundle.train_det2d3d.poses_2d) == 4800
