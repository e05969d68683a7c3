"""Denavit-Hartenberg forward kinematics of the 16-joint DH-AUG human model.

Plain PyTorch port of ``dhaug_tpu/ops/fk.py``.  It is the FK the CPU runs,
and the oracle both CUDA kernels (``ops/fk_cuda.py``) are held to; autograd
through it is the reference for the hand-derived backward kernel.

Conventions (all copied from the reference's ``Forward_Kinematics_DH_Model``):

* angles are packed (..., 33) in chain order
  [right_leg(5), left_leg(5), body(13), right_hand(5), left_hand(5)], degrees;
* modified-DH link: Q = [[ct, -st, 0], [st ca, ct ca, -sa], [st sa, ct sa, ca]],
  t = (a, -sa d, ca d), alpha/theta in degrees;
* each chain is walked as an (R, p) recurrence: p_i = p_{i-1} + R_{i-1} t_i,
  R_i = R_{i-1} Q_i; the two arm chains start from body link 8;
* the 15 bone lengths (FK order) rewrite the a/d entries;
* the global rotation is Rx @ Ry @ Rz of XYZ Euler angles in degrees;
* joints scatter into the H36M 32-slot layout, unused slots stay zero before
  the root is added to all 32, and the 16-joint view gathers from it.
"""
from __future__ import annotations

import math

import torch

# Link angle tables in degrees (forward_kinematics_DH_model.py:234-261).
RIGHT_LEG_ALPHA = (0.0, -90.0, -90.0, 0.0, 0.0)
RIGHT_LEG_THETA = (0.0, -90.0, 180.0, 0.0, 0.0)
LEFT_LEG_ALPHA = (0.0, 90.0, 90.0, 0.0, 0.0)
LEFT_LEG_THETA = (180.0, -90.0, 0.0, 0.0, 0.0)
BODY_ALPHA = (0.0, -90.0, -90.0, -90.0, -90.0, -90.0, -90.0,
              -90.0, -90.0, -90.0, -90.0, -90.0, 90.0)
BODY_THETA = (90.0, -90.0, -90.0, -90.0, -90.0, -90.0, -90.0,
              -90.0, -90.0, -90.0, -90.0, 0.0, 0.0)
RIGHT_HAND_ALPHA = (-90.0, -90.0, -90.0, 0.0, 0.0)
RIGHT_HAND_THETA = (-180.0, -90.0, 180.0, 0.0, 0.0)
LEFT_HAND_ALPHA = (-90.0, 90.0, 90.0, 0.0, 0.0)
LEFT_HAND_THETA = (0.0, -90.0, 0.0, 0.0, 0.0)

# chain -> (alpha, theta, slice of the 33 packed angles)
CHAINS = {
    "right_leg": (RIGHT_LEG_ALPHA, RIGHT_LEG_THETA, (0, 5)),
    "left_leg": (LEFT_LEG_ALPHA, LEFT_LEG_THETA, (5, 10)),
    "body": (BODY_ALPHA, BODY_THETA, (10, 23)),
    "right_hand": (RIGHT_HAND_ALPHA, RIGHT_HAND_THETA, (23, 28)),
    "left_hand": (LEFT_HAND_ALPHA, LEFT_HAND_THETA, (28, 33)),
}

# The 15 bone lengths (FK order) rewrite these a/d entries, every other
# entry of a chain's a and d being 0 (forward_kinematics_DH_model.py:571-589):
# chain -> ((param, link, bone, sign), ...)
BONE_REWRITES = {
    "right_leg": (("a", 0, 5, 1), ("a", 3, 3, 1), ("a", 4, 1, 1)),
    "left_leg": (("a", 0, 4, -1), ("a", 3, 2, 1), ("a", 4, 0, 1)),
    "body": (("a", 12, 14, 1), ("d", 3, 6, 1), ("d", 6, 7, 1)),
    "right_hand": (("a", 0, 9, -1), ("a", 3, 11, 1), ("a", 4, 13, 1)),
    "left_hand": (("a", 0, 8, 1), ("a", 3, 10, 1), ("a", 4, 12, 1)),
}

# 15 bones in FK order: pairs of 16-joint indices
# (forward_kinematics_DH_model.py:46-49).
USED_16KEY_15BONE_TABLE = (
    (5, 6), (2, 3), (4, 5), (1, 2),
    (0, 4), (0, 1), (0, 7), (7, 8), (8, 10), (8, 13),
    (10, 11), (13, 14), (11, 12), (14, 15),
    (8, 9),
)
BONE_NAMES = (
    "left_small_leg", "right_small_leg", "left_big_leg", "right_big_leg",
    "left_hip", "right_hip", "waist", "thorax", "left_shoulder",
    "right_shoulder", "left_big_arm", "right_big_arm", "left_small_arm",
    "right_small_arm", "neck",
)
# Canonical bone lengths of init_Fk_DH_angle.
CANONICAL_BONE_LEN = (0.5, 0.5, 0.6, 0.6, 0.25, 0.25, 0.25, 0.2,
                      0.4, 0.4, 0.4, 0.4, 0.35, 0.35, 0.15)

N_CHAIN_ANGLES = 33
H36M_32_TO_16_TABLE = (0, 1, 2, 3, 6, 7, 8, 12, 13, 15, 17, 18, 19, 25, 26, 27)

# H36M 32-slot scatter: (slot, chain, chain joint index); the hand chains
# count their links from 9 (they continue body link 8).
_SCATTER = (
    (0, "body", 0), (1, "right_leg", 0), (2, "right_leg", 3),
    (3, "right_leg", 4), (6, "left_leg", 0), (7, "left_leg", 3),
    (8, "left_leg", 4), (12, "body", 3), (13, "body", 6), (14, "body", 12),
    (15, "body", 12), (17, "left_hand", 9), (18, "left_hand", 12),
    (19, "left_hand", 13), (25, "right_hand", 9), (26, "right_hand", 12),
    (27, "right_hand", 13),
)

_DEG = math.pi / 180.0


def euler_xyz_rotation(angles_deg: torch.Tensor) -> torch.Tensor:
    """Rx @ Ry @ Rz (..., 3, 3) from (..., 3) XYZ Euler angles in degrees."""
    rad = angles_deg * _DEG
    cx, cy, cz = torch.cos(rad[..., 0]), torch.cos(rad[..., 1]), torch.cos(rad[..., 2])
    sx, sy, sz = torch.sin(rad[..., 0]), torch.sin(rad[..., 1]), torch.sin(rad[..., 2])
    rows = (
        (cy * cz, -cy * sz, sy),
        (sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz, -sx * cy),
        (-cx * sy * cz + sx * sz, cx * sy * sz + sx * cz, cx * cy),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _link_rot_trans(alpha_deg: float, a, d, theta_deg: torch.Tensor):
    """Rotation block Q (..., 3, 3) and translation t (..., 3) of one link.
    ``a``/``d`` are 0.0 or (...,) bone-length tensors."""
    al = alpha_deg * _DEG
    ca, sa = math.cos(al), math.sin(al)
    th = theta_deg * _DEG
    ct, st = torch.cos(th), torch.sin(th)
    zero = torch.zeros_like(ct)
    Q = torch.stack([
        torch.stack([ct, -st, zero], dim=-1),
        torch.stack([st * ca, ct * ca, torch.full_like(ct, -sa)], dim=-1),
        torch.stack([st * sa, ct * sa, torch.full_like(ct, ca)], dim=-1),
    ], dim=-2)
    a = torch.as_tensor(a, dtype=ct.dtype, device=ct.device).expand(ct.shape)
    d = torch.as_tensor(d, dtype=ct.dtype, device=ct.device).expand(ct.shape)
    t = torch.stack([a, -sa * d, ca * d], dim=-1)
    return Q, t


def _run_chain(alphas, a_list, d_list, theta0, angles, start_R=None, start_p=None):
    """Unrolled (R, p) walk.  Returns the per-link positions and cumulative
    rotations.  ``angles`` (..., L) are added to the theta offsets."""
    positions, rotations = [], []
    R, p = start_R, start_p
    for i in range(len(alphas)):
        Q, t = _link_rot_trans(alphas[i], a_list[i], d_list[i],
                               theta0[i] + angles[..., i])
        if R is None:
            p, R = t, Q
        else:
            p = p + (R @ t.unsqueeze(-1)).squeeze(-1)
            R = R @ Q
        positions.append(p)
        rotations.append(R)
    return positions, rotations


def fk_world_pose(angles: torch.Tensor, bone_len: torch.Tensor,
                  global_rot: torch.Tensor, root: torch.Tensor,
                  n_joints: int = 32) -> torch.Tensor:
    """World pose (..., 32, 3), or the 16-joint gather when ``n_joints == 16``.

    angles (..., 33) degrees, bone_len (..., 15) metres in FK bone order,
    global_rot (..., 3) XYZ Euler degrees, root (..., 3) metres.
    """
    def walk(name, start_R=None, start_p=None):
        alphas, thetas, (lo, hi) = CHAINS[name]
        a, d = [0.0] * len(alphas), [0.0] * len(alphas)
        for param, link, bone, sign in BONE_REWRITES[name]:
            (a if param == "a" else d)[link] = bone_len[..., bone] if sign > 0 \
                else -bone_len[..., bone]
        return _run_chain(alphas, a, d, thetas, angles[..., lo:hi], start_R, start_p)

    rl_pos, _ = walk("right_leg")
    ll_pos, _ = walk("left_leg")
    body_pos, body_rot = walk("body")
    # the arm chains continue from body link 8's cumulative (R, p)
    rh_pos, _ = walk("right_hand", body_rot[8], body_pos[8])
    lh_pos, _ = walk("left_hand", body_rot[8], body_pos[8])
    chains = {"right_leg": rl_pos, "left_leg": ll_pos, "body": body_pos,
              "right_hand": {9 + i: p for i, p in enumerate(rh_pos)},
              "left_hand": {9 + i: p for i, p in enumerate(lh_pos)}}

    points = torch.stack([chains[c][j] for (_, c, j) in _SCATTER], dim=-2)
    R_glob = euler_xyz_rotation(global_rot.to(angles.dtype))
    points = points @ R_glob.transpose(-1, -2)

    batch_shape = points.shape[:-2]
    pose32 = points.new_zeros(batch_shape + (32, 3))
    slots = torch.as_tensor([s for (s, _, _) in _SCATTER], device=points.device)
    pose32 = pose32.index_copy(-2, slots, points)
    pose32 = pose32 + root[..., None, :]
    if n_joints == 32:
        return pose32
    if n_joints == 16:
        return pose32[..., list(H36M_32_TO_16_TABLE), :]
    raise ValueError(f"n_joints must be 16 or 32, got {n_joints}")


def fk_world_pose_16(angles, bone_len, global_rot, root) -> torch.Tensor:
    """The plain 16-joint FK: (B, 33), (B, 15), (B, 3), (B, 3) -> (B, 16, 3)."""
    return fk_world_pose(angles, bone_len, global_rot, root, n_joints=16)


def init_fk_dh_angle(dtype=torch.float32, device=None) -> torch.Tensor:
    """The zero-angle pose with the canonical bone lengths, (32, 3): the
    golden fixture of init_Fk_DH_angle (forward_kinematics_DH_model.py:824-858)."""
    zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return fk_world_pose(zeros(N_CHAIN_ANGLES),
                         torch.tensor(CANONICAL_BONE_LEN, dtype=dtype, device=device),
                         zeros(3), zeros(3))
