"""WGAN critics of the single-frame FK-GAN (port of the 3D and 2D critics of
``dhaug_tpu/models/discriminators.py``)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from dhaug_torch.models.blocks import DensePrelude, DenseResBlock, ResTower, dense
from dhaug_torch.ops.bones import kcs_features


class Fk3DDiscriminator(nn.Module):
    """Two-branch critic on root-relative 3D poses (B, 16, 3):
    KCS(30) tower || raw-pose(48) tower -> merge(100) -> scalar."""

    def __init__(self, dense_dim: int = 1000):  # --Dis_DenseDim_3D
        super().__init__()
        self.kcs_tower = ResTower(30, dense_dim)
        self.pose_tower = ResTower(48, dense_dim)
        self.merge = DensePrelude(2 * dense_dim, 100)
        self.merge_block = DenseResBlock(100)
        self.out = dense(100, 1)

    def forward(self, pose3d: torch.Tensor) -> torch.Tensor:
        pose3d = pose3d.reshape(-1, 16, 3)
        merged = torch.cat([self.kcs_tower(kcs_features(pose3d)),
                            self.pose_tower(pose3d.reshape(-1, 48))], dim=-1)
        return self.out(self.merge_block(self.merge(merged)))


class Fk2DDiscriminator(nn.Module):
    """LeakyReLU MLP on (B, 16, 2) with one residual hop:
    d3 = lrelu(l3(d2) + d1); d4 has no activation."""

    def __init__(self, dense_dim: int = 1000):  # --Dis_DenseDim_2D
        super().__init__()
        self.fc1 = dense(32, dense_dim)
        self.fc2 = dense(dense_dim, dense_dim)
        self.fc3 = dense(dense_dim, dense_dim)
        self.fc4 = dense(dense_dim, dense_dim)
        self.fc5 = dense(dense_dim, dense_dim)
        self.out = dense(dense_dim, 1)

    def forward(self, pose2d: torch.Tensor) -> torch.Tensor:
        x = pose2d.reshape(-1, 32)
        d1 = F.leaky_relu(self.fc1(x))
        d2 = F.leaky_relu(self.fc2(d1))
        d3 = F.leaky_relu(self.fc3(d2) + d1)
        d4 = self.fc4(d3)
        return self.out(F.leaky_relu(self.fc5(d4)))
