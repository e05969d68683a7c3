"""Bone-vector algebra, the bone-length re-skin, and KCS critic features.

Port of what the single-frame path uses from ``dhaug_tpu/ops/bones.py``.
Two bone orderings coexist, as in the reference: the FK order (what the
generator harvests and the critics see) and the H36M kinematic-tree order
(what the re-skin templates are written in).  Each (16, 15) incidence matrix
is a constant, and one einsum does the batched contraction.
"""
from __future__ import annotations

import numpy as np
import torch

from dhaug_torch.ops.fk import USED_16KEY_15BONE_TABLE

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


def reskin_pose(pose16: torch.Tensor, new_lengths_tree: torch.Tensor) -> torch.Tensor:
    """Replace the bone lengths with ``new_lengths_tree`` (tree order,
    (..., 15)), keeping bone directions and the root position."""
    root = pose16[..., :1, :]
    vecs = bone_vectors_tree(pose16 - root)
    unit = vecs / bone_lengths(vecs)[..., None]
    return pose_from_bone_vectors_tree(unit * new_lengths_tree[..., None]) + root


def kcs_features(pose16: torch.Tensor) -> torch.Tensor:
    """The 3D critic's kinematic-chain-space input: 15 inter-bone cosines and
    15 bone lengths, (..., 16, 3) -> (..., 30)."""
    vecs = bone_vectors_fk(pose16)
    lens = bone_lengths(vecs)
    va = vecs[..., _KCS_A, :]
    vb = vecs[..., _KCS_B, :]
    cos = torch.sum(va * vb, dim=-1) / (lens[..., _KCS_A] * lens[..., _KCS_B])
    return torch.cat([cos, lens], dim=-1)
