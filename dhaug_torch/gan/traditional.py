"""The non-GAN "traditional" random FK augmenter (``--data_enhancement_method
normal``): port of ``dhaug_tpu/gan/traditional.py``.

Each pose activates a random-size random subset of the 34 DOFs, whose
angles come from a Gaussian centred mid-range (sigma 60 degrees) clipped to
the traditional per-joint ranges, with a clipped random global rotation,
bone lengths and a root harvested from a pool of real world poses, and the
``--bone_len_scaler`` ratios.  All poses go through one FK call:
``ops/fk_cuda.fk_world_pose_16``, so on the card kernel B1 computes them.

Random draws come from a ``torch.Generator`` (:func:`draw_traditional`);
:func:`traditional_poses_from_draws` takes the draws, so a test can feed it
the numbers the JAX function draws from its key.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dhaug_torch.models.generator import sample_scaler8, scale_bone_lengths
from dhaug_torch.ops import fk_cuda
from dhaug_torch.ops.bones import bone_lengths_fk
from dhaug_torch.ops.camera import project_to_2d, world_to_camera_batch

# Traditional per-joint angle ranges (forward_kinematics_DH_model.py:935-971),
# (lo, hi) for joints 1..34.  joint24 has no range in the reference and is
# excluded from the packed output; it gets (0, 0).
_TRAD_RANGES = (
    (-90, 45), (-90, 45), (-45, 120), (-135, 0), (0, 0),
    (-45, 90), (-45, 90), (-45, 120), (-135, 0), (0, 0),
    (-25, 25), (-10, 90), (-20, 20), (-20, 20), (-10, 45),
    (-25, 25), (-20, 20), (0, 0), (-20, 20), (-90, 90),
    (-20, 90), (-45, 45), (0, 0), (0, 0),
    (-135, 45), (-135, 45), (-45, 180), (0, 135), (0, 0),
    (-45, 135), (-45, 135), (-45, 180), (0, 135), (0, 0),
)
TRAD_LO = np.array([lo for lo, _ in _TRAD_RANGES], np.float32)   # (34,)
TRAD_HI = np.array([hi for _, hi in _TRAD_RANGES], np.float32)
# global rotation ranges (:972-976)
TRAD_GLOBAL_LO = np.array([-20.0, -20.0, -180.0], np.float32)
TRAD_GLOBAL_HI = np.array([20.0, 20.0, 180.0], np.float32)
_ANGLE_SIGMA = 60.0
# the packed 33-angle layout drops joint24 (index 23)
_PACK_34_TO_33 = [i for i in range(34) if i != 23]


class TraditionalConfig(NamedTuple):
    n_poses: int = 10000                # --generator_whole_number
    use_dataset_bone_len: bool = True   # --generator_choose_BoneLen
    use_dataset_root: bool = True       # --generator_choose_root_pos
    use_global_rot: bool = True         # --generator_global_rot
    bone_len_scaler: str = "different"  # --bone_len_scaler


class TraditionalDraws(NamedTuple):
    """The random numbers behind ``n`` traditional poses."""
    count: torch.Tensor          # (n, 1) int in [0, 34): active DOFs a pose
    scores: torch.Tensor         # (n, 34) uniform: which DOFs (by rank)
    angle_normal: torch.Tensor   # (n, 34) standard normal
    global_normal: torch.Tensor  # (n, 3) standard normal
    bl_idx: torch.Tensor         # (n,) pool row lending the bone lengths
    root_idx: torch.Tensor       # (n,) pool row lending the root
    scaler8: torch.Tensor        # (n, 8) bone-length scaler ratios


def draw_traditional(n: int, pool_size: int, bone_len_scaler: str,
                     generator: torch.Generator, device) -> TraditionalDraws:
    kw = dict(generator=generator, device=device)
    return TraditionalDraws(
        count=torch.randint(0, 34, (n, 1), **kw),
        scores=torch.rand((n, 34), **kw),
        angle_normal=torch.randn((n, 34), **kw),
        global_normal=torch.randn((n, 3), **kw),
        bl_idx=torch.randint(0, pool_size, (n,), **kw),
        root_idx=torch.randint(0, pool_size, (n,), **kw),
        scaler8=sample_scaler8(n, bone_len_scaler, generator, device))


def sample_traditional_angles(d: TraditionalDraws):
    """(angles33, global_rot3) in degrees from the draws ``d``: the active
    DOFs (the ``count`` lowest-ranked ``scores``) take their Gaussian angle
    clipped to the joint's range, the others 0; the global rotation is
    clipped likewise."""
    device = d.scores.device
    lo, hi = (torch.as_tensor(a, device=device) for a in (TRAD_LO, TRAD_HI))
    raw = torch.clamp((lo + hi) / 2.0 + _ANGLE_SIGMA * d.angle_normal, lo, hi)
    ranks = torch.argsort(torch.argsort(d.scores, dim=1), dim=1)
    angles33 = torch.where(ranks < d.count, raw, torch.zeros_like(raw))[:, _PACK_34_TO_33]
    glo, ghi = (torch.as_tensor(a, device=device) for a in (TRAD_GLOBAL_LO, TRAD_GLOBAL_HI))
    return angles33, torch.clamp((glo + ghi) / 2.0 + _ANGLE_SIGMA * d.global_normal, glo, ghi)


@torch.no_grad()
def traditional_poses_from_draws(d: TraditionalDraws, pose_pool_16: torch.Tensor,
                                 cfg: TraditionalConfig):
    """World poses from the draws ``d``; ``pose_pool_16`` (P, 16, 3) holds
    real world poses.  Returns (pose16 (n, 16, 3), angles33 deg,
    global_rot deg, bone_len, root)."""
    n = d.scores.shape[0]
    angles33, global_rot = sample_traditional_angles(d)
    if not cfg.use_global_rot:
        global_rot = torch.zeros_like(global_rot)
    # the first pose is the rest pose (the reference's frame_num > 0 gate)
    angles33[0] = 0.0
    global_rot[0] = 0.0

    pool_bl = bone_lengths_fk(pose_pool_16)
    if cfg.use_dataset_bone_len:
        bone_len = pool_bl[d.bl_idx]
    else:
        bone_len = pool_bl[:1].expand(n, 15)
    if cfg.use_dataset_root:
        root = pose_pool_16[d.root_idx, 0]
    else:
        root = pose_pool_16.new_zeros((n, 3))
    bone_len = scale_bone_lengths(bone_len, d.scaler8)
    pose16 = fk_cuda.fk_world_pose_16(angles33.contiguous(), bone_len.contiguous(),
                                      global_rot.contiguous(), root.contiguous())
    return pose16, angles33, global_rot, bone_len, root


def generate_traditional_poses(generator: torch.Generator, pose_pool_16: torch.Tensor,
                               cfg: TraditionalConfig):
    """``cfg.n_poses`` augmented world poses, drawn from ``generator`` on
    the pool's device; the tuple of :func:`traditional_poses_from_draws`."""
    d = draw_traditional(cfg.n_poses, pose_pool_16.shape[0], cfg.bone_len_scaler,
                         generator, pose_pool_16.device)
    return traditional_poses_from_draws(d, pose_pool_16, cfg)


@torch.no_grad()
def project_through_cameras(pose16_world: torch.Tensor, cam_quats: torch.Tensor,
                            cam_trans: torch.Tensor, cam_intrs: torch.Tensor):
    """Project a pose set through every (subject, camera) pair of the bank,
    as the traditional path feeds the posenet with all 4 cameras of every
    training subject (model_fk_gan_train.py:52-84).  Returns
    (pos3d_cam (C*N, 16, 3), pos2d (C*N, 16, 2))."""
    n = pose16_world.shape[0]
    outs_3d, outs_2d = [], []
    for c in range(cam_quats.shape[0]):
        cam3d = world_to_camera_batch(pose16_world, cam_quats[c][None], cam_trans[c][None])
        outs_3d.append(cam3d)
        outs_2d.append(project_to_2d(cam3d, cam_intrs[c][None].expand(n, 9)))
    return torch.cat(outs_3d), torch.cat(outs_2d)
