"""Posenet factory keyed on ``--posenet_name``: port of
``dhaug_tpu/models/factory.py``.

The five names build the same architectures as the JAX package; for the
multi-frame names ``flag`` 'train' picks the strided twin and 'test' the
dilated one (PoseFormer: drop-path 0.1 or 0).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from dhaug_torch.models.posenets import LinearModel, PoseFormer, SemGCN, TemporalPoseNet

POSENET_NAMES = ("gcn", "mlp", "videopose", "mulit_farme_videopose",
                 "mulit_farme_poseformer")
SINGLE_FRAME_NAMES = ("gcn", "mlp", "videopose")


def receptive_field(architecture: str) -> int:
    """'3,3' -> 9; '3,3,3' -> 27."""
    return math.prod(int(w) for w in architecture.split(","))


def adjacency_from_edges(num_joints: int, edges) -> np.ndarray:
    """Row-normalized symmetric adjacency with self-loops."""
    A = np.zeros((num_joints, num_joints), np.float32)
    for i, j in edges:
        A[i, j] = 1.0
        A[j, i] = 1.0
    A = A + np.eye(num_joints, dtype=np.float32)
    rowsum = A.sum(1)
    inv = np.where(rowsum > 0, 1.0 / rowsum, 0.0)
    return (A * inv[:, None]).astype(np.float32)


def adjacency_from_skeleton(skeleton) -> np.ndarray:
    """The graph of ``skeleton``'s parent links (``data/skeleton.py``)."""
    edges = [(c, p) for c, p in enumerate(skeleton.parents()) if p >= 0]
    return adjacency_from_edges(skeleton.num_joints(), edges)


def make_posenet(posenet_name: str, *, stages: int = 4, dropout: float = 0.25,
                 architecture: str = "3,3,3", skeleton=None,
                 flag: str = "train") -> torch.nn.Module:
    """gcn/mlp/videopose take (B, 16, 2) and return (B, 16, 3); the
    multi-frame nets take (B, T, 16, 2)."""
    if posenet_name == "gcn":
        if skeleton is None:
            raise ValueError("gcn posenet needs a skeleton")
        return SemGCN(adjacency_from_skeleton(skeleton), hid_dim=128, num_layers=stages,
                      p_dropout=dropout)
    if posenet_name == "mlp":
        return LinearModel(num_stage=stages, p_dropout=dropout)
    if posenet_name == "videopose":
        return TemporalPoseNet([1] * (stages + 1), out_joints=15, pad_hip_joint=True,
                               p_dropout=0.25, strided=True)
    if posenet_name == "mulit_farme_videopose":
        return TemporalPoseNet([int(w) for w in architecture.split(",")], out_joints=16,
                               pad_hip_joint=False, p_dropout=0.25,
                               strided=(flag == "train"))
    if posenet_name == "mulit_farme_poseformer":
        return PoseFormer(num_frame=receptive_field(architecture), num_joints=16,
                          drop_path_rate=0.1 if flag == "train" else 0.0)
    raise ValueError(f"posenet_name invalid: {posenet_name}")


def example_input(posenet_name: str, batch: int = 2,
                  architecture: str = "3,3,3") -> torch.Tensor:
    if posenet_name in SINGLE_FRAME_NAMES:
        return torch.zeros((batch, 16, 2))
    return torch.zeros((batch, receptive_field(architecture), 16, 2))
