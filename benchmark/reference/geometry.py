"""Plain PyTorch geometry of the DH-AUG pose model, for the benchmark's
reference and its pose pool: the 16-joint Denavit-Hartenberg forward
kinematics (FK), bone vectors and lengths, the bone-length re-skin, KCS
critic features, quaternion camera transforms, the H36M projection with
distortion, the left/right flip and time reversal.

A frozen copy of the published model's equations as the port writes them
(its FK, bones, camera and augmentation modules); it imports nothing of the
port, so a fault in the port's geometry shows as a gap against it.
"""
from __future__ import annotations

import math

import numpy as np
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



def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` (..., 3) by unit quaternion(s) ``q`` (..., 4); leading
    dims broadcast.  Cross-product form v + 2*(w*(qv x v) + qv x (qv x v))."""
    shape = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
    q = q.expand(shape + (4,))
    v = v.expand(shape + (3,))
    w = q[..., :1]
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def qinverse(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion: (w, -x, -y, -z)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def world_to_camera(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """World -> camera frame.  X: (..., 3); R: quaternion broadcastable to
    (..., 4); t broadcastable to (..., 3)."""
    return qrot(qinverse(R), X - t)


def camera_to_world(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera -> world frame (inverse of :func:`world_to_camera`)."""
    return qrot(R, X) + t


def camera_to_world_batch(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample extrinsics: X (B, J, 3), R (B, 4), t (B, 3)."""
    return camera_to_world(X, R[:, None, :], t[:, None, :])


def world_to_camera_batch(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample extrinsics world->camera: X (B, J, 3), R (B, 4) or (1, 4)."""
    if R.ndim == 2:
        R = R[:, None, :]
    if t.ndim == 2:
        t = t[:, None, :]
    return world_to_camera(X, R, t)


def clip_unit(x: torch.Tensor) -> torch.Tensor:
    """``x`` clamped to [-1, 1] as ``jnp.clip`` does it: max then min.

    The gradient matters here because the generator loss is differentiated
    through the projection.  ``torch.clamp`` passes the whole gradient at a
    value exactly on the bound; ``jnp.clip`` (``maximum`` then ``minimum``)
    splits it evenly between the tie's two sides, giving 0.5.  torch's
    ``maximum``/``minimum`` split ties the same way, so composing them
    mirrors the JAX gradient exactly: 1 inside, 0.5 on a bound, 0 outside.
    """
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, -one), one)


def project_to_2d(X: torch.Tensor, camera_params: torch.Tensor) -> torch.Tensor:
    """Project camera-space 3D points through the full H36M camera model.

    X: (N, ..., 3); camera_params: (N, 9) = [f(2), c(2), k(3), p(2)] (only
    [:9] of a longer record is read).  The perspective divide is clamped to
    [-1, 1] as the reference does (common/camera.py:85).
    """
    params = camera_params[..., :9]
    while params.ndim < X.ndim:
        params = params[:, None]
    f = params[..., :2]
    c = params[..., 2:4]
    k = params[..., 4:7]
    p = params[..., 7:9]

    XX = clip_unit(X[..., :2] / X[..., 2:])
    r2 = torch.sum(XX ** 2, dim=-1, keepdim=True)
    radial = 1.0 + torch.sum(k * torch.cat([r2, r2 ** 2, r2 ** 3], dim=-1),
                             dim=-1, keepdim=True)
    tan = torch.sum(p * XX, dim=-1, keepdim=True)
    XXX = XX * (radial + tan) + p * r2
    return f * XXX + c



# H36M kinematic-tree bone list (parent, child) in gan_utils order.
H36M_TREE_BONES = (
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7), (7, 8),
    (8, 9), (8, 10), (10, 11), (11, 12), (8, 13), (13, 14), (14, 15),
)


def _incidence(bones) -> np.ndarray:
    """(16, n_bones) C with C[parent, b] = -1, C[child, b] = +1."""
    C = np.zeros((16, len(bones)), dtype=np.float32)
    for b, (parent, child) in enumerate(bones):
        C[parent, b] = -1.0
        C[child, b] = 1.0
    return C


_C_FK = _incidence(USED_16KEY_15BONE_TABLE)
_C_TREE = _incidence(H36M_TREE_BONES)

# Inverse map: sum tree-ordered bone vectors along each joint's root path.
_parent_of = {child: parent for parent, child in H36M_TREE_BONES}
_bone_of_child = {child: b for b, (parent, child) in enumerate(H36M_TREE_BONES)}
_C_TREE_INV = np.zeros((15, 16), dtype=np.float32)
for _j in range(1, 16):
    _node = _j
    while _node != 0:
        _C_TREE_INV[_bone_of_child[_node], _j] = 1.0
        _node = _parent_of[_node]

# Adjacent-bone pairs (FK bone indices) whose cosines feed the 3D critic
# (Fk_discriminator.py:81-140).
_KCS_PAIRS = (
    (0, 2), (1, 3), (2, 4), (3, 5), (4, 5), (4, 6), (5, 6), (6, 7),
    (7, 14), (7, 8), (7, 9), (8, 10), (9, 11), (10, 12), (11, 13),
)
_KCS_A = [a for a, _ in _KCS_PAIRS]
_KCS_B = [b for _, b in _KCS_PAIRS]


def _const(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def bone_vectors_fk(pose16: torch.Tensor) -> torch.Tensor:
    """(..., 16, 3) -> (..., 15, 3) bone vectors in FK order."""
    return torch.einsum("jb,...jc->...bc", _const(_C_FK, pose16), pose16)


def bone_vectors_tree(pose16: torch.Tensor) -> torch.Tensor:
    """(..., 16, 3) -> (..., 15, 3) bone vectors in kinematic-tree order."""
    return torch.einsum("jb,...jc->...bc", _const(_C_TREE, pose16), pose16)


def pose_from_bone_vectors_tree(bones: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`bone_vectors_tree`: (..., 15, 3) -> (..., 16, 3)
    with the root at the origin."""
    return torch.einsum("bj,...bc->...jc", _const(_C_TREE_INV, bones), bones)


def bone_lengths(bone_vecs: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(bone_vecs ** 2, dim=-1))


def bone_lengths_fk(pose16: torch.Tensor) -> torch.Tensor:
    """(..., 16, 3) -> (..., 15) bone lengths in FK order."""
    return bone_lengths(bone_vectors_fk(pose16))


def bone_unit_vectors_tree(pose16: torch.Tensor) -> torch.Tensor:
    """(..., 16, 3) -> (..., 15, 3) unit bone directions in tree order."""
    vecs = bone_vectors_tree(pose16)
    return vecs / bone_lengths(vecs)[..., None]


def reskin_pose(pose16: torch.Tensor, new_lengths_tree: torch.Tensor) -> torch.Tensor:
    """Replace the bone lengths with ``new_lengths_tree`` (tree order,
    (..., 15)), keeping bone directions and the root position."""
    root = pose16[..., :1, :]
    unit = bone_unit_vectors_tree(pose16 - root)
    return pose_from_bone_vectors_tree(unit * new_lengths_tree[..., None]) + root


def kcs_features(pose16: torch.Tensor, with_lengths: bool = True) -> torch.Tensor:
    """Kinematic-chain-space critic input: 15 inter-bone cosines, followed by
    the 15 bone lengths when ``with_lengths``, (..., 16, 3) -> (..., 30) or
    (..., 15).  ``with_lengths=False`` is the motion critics' variant
    (Fk_discriminator.py:269-377)."""
    vecs = bone_vectors_fk(pose16)
    lens = bone_lengths(vecs)
    va = vecs[..., _KCS_A, :]
    vb = vecs[..., _KCS_B, :]
    cos = torch.sum(va * vb, dim=-1) / (lens[..., _KCS_A] * lens[..., _KCS_B])
    if with_lengths:
        return torch.cat([cos, lens], dim=-1)
    return cos


# left/right 16-joint slots (H36M 16-joint layout) and the permutation that
# swaps them
JOINTS_LEFT_16 = (4, 5, 6, 10, 11, 12)
JOINTS_RIGHT_16 = (1, 2, 3, 13, 14, 15)
FLIP_PERM = (0, 4, 5, 6, 1, 2, 3, 7, 8, 9, 13, 14, 15, 10, 11, 12)


def flip_pose(pose: torch.Tensor) -> torch.Tensor:
    """Mirror a 16-joint pose (..., 16, C) in x and swap left/right joints."""
    flipped = torch.cat([-pose[..., :1], pose[..., 1:]], dim=-1)
    return flipped.index_select(-2, torch.as_tensor(FLIP_PERM, device=pose.device))


def time_reverse(clip: torch.Tensor) -> torch.Tensor:
    """Reverse the frame axis of (..., F, J, C) clips."""
    return torch.flip(clip, dims=(-3,))
