"""The port's three tools on the CPU: ``dhaug_torch.visualize_fk`` and
``dhaug_torch.make_fk_inspector`` against the JAX package's FK and the JAX
script's page spec, and ``dhaug_torch.profile_epoch`` at narrow widths
(one epoch of each mode: its phases in order, finite seconds, every net
trained)."""
import copy
import importlib.util
import json
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch import make_fk_inspector, profile_epoch, visualize_fk
from dhaug_torch.train.config import parse_aug_args
from dhaug_torch.utils import viz
from dhaug_tpu.gan import traditional as j_trad
from dhaug_tpu.ops import fk as j_fk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_fk16(angles, bone_len, global_rot):
    n = len(angles)
    return np.asarray(j_fk.fk_world_pose(j_fk.FKInputs(
        jnp.asarray(angles, jnp.float32),
        jnp.broadcast_to(jnp.asarray(bone_len, jnp.float32), (n, 15)),
        jnp.broadcast_to(jnp.asarray(global_rot, jnp.float32), (n, 3)),
        jnp.zeros((n, 3), jnp.float32)), n_joints=16))


def _is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("flags", [
    ["--sweep", "3", "--steps", "6"],
    ["--sweep", "24", "--global_rot", "10,-20,30", "--bone_len", ",".join(["0.3"] * 15)],
    ["--angles", "0,0,30,-60,0,5,-5", "--global_rot", "0,0,45"],
], ids=["knee_sweep", "sweep_with_rotation_and_lengths", "angles"])
def test_visualize_fk_against_the_jax_fk(flags, tmp_path):
    out = visualize_fk.main(flags + ["--out", str(tmp_path / "fk.png"), "--device", "cpu"])
    assert _is_png(out["path"]) and out["launches"] == 0
    args = visualize_fk.parse_args(flags)
    want = _jax_fk16(out["angles"], args.bone_len, args.global_rot)
    assert out["poses"].shape == want.shape == (len(out["angles"]), 16, 3)
    np.testing.assert_allclose(out["poses"], want, atol=1e-6, rtol=0)
    if args.sweep >= 0:
        k = j_trad._PACK_34_TO_33[args.sweep]
        assert out["sweep_range"] == (float(j_trad.TRAD_LO[k]), float(j_trad.TRAD_HI[k]))
        np.testing.assert_array_equal(out["angles"][:, args.sweep],
                                      np.linspace(*out["sweep_range"], args.steps).astype(np.float32))
    else:
        assert out["sweep_range"] is None and out["angles"][0, 3] == -60


def test_visualize_fk_refuses_bad_flags(tmp_path):
    for flags in (["--sweep", "33"], ["--bone_len", "0.3,0.3"], ["--global_rot", "1,2"]):
        with pytest.raises(SystemExit):
            visualize_fk.main(flags + ["--out", str(tmp_path / "x.png"), "--device", "cpu"])
    assert not (tmp_path / "x.png").exists()


def test_pose_grid_renders_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is absent the viewer draws its grid with Pillow and
    says so; the library's plotter still needs matplotlib."""
    def no_matplotlib():
        raise ImportError("no matplotlib")
    monkeypatch.setattr(viz, "_plt", no_matplotlib)
    out = visualize_fk.main(["--sweep", "3", "--steps", "6", "--device", "cpu",
                             "--out", str(tmp_path / "sub" / "grid.png")])
    assert out["renderer"] == "pillow" and _is_png(out["path"])
    from PIL import Image
    with Image.open(out["path"]) as img:
        assert img.size == (4 * 240, 2 * 240 + 24)
        assert len(img.getcolors(maxcolors=1 << 16)) > 2     # lines drawn in colour
    with pytest.raises(ImportError):
        viz.plot_pose_grid_3d(out["poses"], str(tmp_path / "grid2.png"))


def _jax_script_spec():
    spec = importlib.util.spec_from_file_location(
        "jax_make_fk_inspector", os.path.join(REPO, "scripts", "make_fk_inspector.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.build_spec()


def test_inspector_page_against_the_jax_script(tmp_path):
    """The page's SPEC equals the JAX script's in every field but the
    golden poses, which match the JAX FK to 1e-5 m (the page rounds them to
    6 decimals); the page carries the same viewer."""
    path = make_fk_inspector.generate(str(tmp_path / "insp.html"), torch.device("cpu"))
    html = open(path).read()
    assert "<canvas" in html and "selfTest" in html and "fkPose16" in html
    assert "dhaug_torch.ops.fk" in html
    spec = json.loads(re.search(r"const SPEC = (\{.*?\});\n", html, re.S).group(1))
    want = json.loads(json.dumps(_jax_script_spec()))
    assert set(spec) == set(want)
    for key in set(spec) - {"goldens"}:
        assert spec[key] == want[key], key
    assert len(spec["scatter16"]) == 16 and len(spec["goldens"]) == 4
    for got, ref in zip(spec["goldens"], want["goldens"]):
        assert {k: got[k] for k in ("angles", "bone_len", "global_rot")} == \
            {k: ref[k] for k in ("angles", "bone_len", "global_rot")}
        pose = _jax_fk16([got["angles"]], got["bone_len"], got["global_rot"])[0]
        np.testing.assert_allclose(np.asarray(got["pose"]), pose, atol=1e-5)


# narrow profiler runs: the fixture cut to 1200 frames (--downsample 4) in
# batches of 200 (6 GAN iterations, the generator updated at the 5th), and to
# 600 frames (--downsample 8) in clips of 64 (9 video GAN iterations); nets
# 32-48 wide
NARROW = {
    False: (200, ["--downsample", "4", "--stages", "1", "--Gen_DenseDim", "32",
                  "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32"]),
    True: (64, ["--downsample", "8", "--Gen_DenseDim", "48", "--Dis_DenseDim_3D", "48",
                "--Dis_DenseDim_2D", "48", "--video_Dis_DenseDim_3D", "48",
                "--video_Dis_DenseDim_2D", "48"]),
}


def _narrow_posenet(name, *, stages=4, dropout=0.25, architecture="3,3,3", skeleton=None,
                    flag="train"):
    from dhaug_torch.models.factory import make_posenet
    from dhaug_torch.models.posenets import TemporalPoseNet
    if name == "mulit_farme_videopose":
        return TemporalPoseNet([int(w) for w in architecture.split(",")], out_joints=16,
                               channels=32, strided=flag == "train")
    return make_posenet(name, stages=stages, dropout=dropout, architecture=architecture,
                        skeleton=skeleton, flag=flag)


@pytest.mark.parametrize("video", [False, True], ids=["single_frame", "video"])
def test_profile_epoch_phases(video, monkeypatch):
    """One epoch: every phase in order with finite seconds, every net's
    weights moved from their initial values, no kernel launch on the CPU."""
    initial = {}

    def recording(build):
        def wrapped(*a, **kw):
            out = build(*a, **kw)
            nets = [out] if isinstance(out, torch.nn.Module) else \
                [getattr(out, n) for n in ("gen", "d3d", "d2d", "md3d", "md2d")
                 if hasattr(out, n)]
            for net in nets:
                initial[id(net)] = copy.deepcopy(net.state_dict())
            return out
        return wrapped

    monkeypatch.setattr(profile_epoch, "make_posenet", recording(_narrow_posenet))
    monkeypatch.setattr(profile_epoch, "build_gan", recording(profile_epoch.build_gan))
    monkeypatch.setattr(profile_epoch, "build_video_gan",
                        recording(profile_epoch.build_video_gan))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        batch, narrow = NARROW[video]
        args = parse_aug_args(profile_epoch.profile_argv(video, REPO, batch, "cpu") + narrow)
        profile = profile_epoch.profile_video if video else profile_epoch.profile_single_frame
        out = profile(args, 1, torch.device("cpu"))
    finally:
        torch.set_num_threads(n)

    names = [name for name, _ in out["phases"]]
    if video:
        assert names == ["video data prep", *profile_epoch.VIDEO_PHASES]
        assert set(out["nets"]) == {"pos", "gen", "d3d", "d2d", "md3d", "md2d"}
    else:
        assert names == ["data prep", *profile_epoch.SINGLE_FRAME_PHASES]
        assert set(out["nets"]) == {"pos", "gen", "d3d", "d2d"}
    assert all(math.isfinite(s) and s >= 0 for _, s in out["phases"])
    assert out["launches"] == {"fwd": 0, "bwd": 0}
    for name, net in out["nets"].items():
        before = initial[id(net)]
        moved = [k for k, v in net.state_dict().items()
                 if v.is_floating_point() and not torch.equal(v, before[k])]
        assert moved, f"{name} did not train"
        for k, v in out["state"][name].items():
            assert v.device.type == "cpu" and torch.equal(v, net.state_dict()[k])
