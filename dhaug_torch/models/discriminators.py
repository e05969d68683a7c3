"""WGAN critics of the FK-GAN: the single-frame 3D and 2D critics and the
video mode's motion critics (port of ``dhaug_tpu/models/discriminators.py``).

Temporal differences are one slice-subtract over the frame axis."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from dhaug_torch.models.blocks import DensePrelude, DenseResBlock, ResTower, dense
from dhaug_torch.ops.bones import kcs_features


class Fk3DDiscriminator(nn.Module):
    """Two-branch critic on root-relative 3D poses (B, 16, 3):
    KCS(30) tower || raw-pose(48) tower -> merge(100) -> scalar."""

    role = "d3d"  # its updates are traced as gan.critic.d3d

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

    role = "d2d"  # its updates are traced as gan.critic.d2d

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


def temporal_diff(x: torch.Tensor) -> torch.Tensor:
    """(B, F, ...) -> (B, F-1, ...) adjacent-frame differences."""
    return x[:, 1:] - x[:, :-1]


class MotionFk3DDiscriminator(nn.Module):
    """Motion 3D critic over clips (B, F, 16, 3): KCS (F x 15) and
    diff-KCS ((F-1) x 15) towers always on; raw-3D (F x 48) and diff-3D
    ((F-1) x 48) towers gated by --motion_Dis_whether_use_3dPos_branch and
    --motion_Dis_whether_use_3dDiff_branch."""

    role = "md3d"  # its updates are traced as gan.critic.md3d

    def __init__(self, video_frames: int, dense_dim: int = 1000,  # --video_Dis_DenseDim_3D
                 use_pos_branch: bool = True, use_diff_branch: bool = True):
        super().__init__()
        F_ = self.video_frames = video_frames
        self.kcs_tower = ResTower(F_ * 15, dense_dim)
        self.kcs_diff_tower = ResTower((F_ - 1) * 15, dense_dim)
        self.pose_tower = ResTower(F_ * 48, dense_dim) if use_pos_branch else None
        self.pose_diff_tower = ResTower((F_ - 1) * 48, dense_dim) if use_diff_branch else None
        n_towers = 2 + int(use_pos_branch) + int(use_diff_branch)
        self.merge = DensePrelude(n_towers * dense_dim, 100)
        self.merge_block = DenseResBlock(100)
        self.out = dense(100, 1)

    def forward(self, clip3d: torch.Tensor) -> torch.Tensor:
        F_ = self.video_frames
        clip3d = clip3d.reshape(-1, F_, 16, 3)
        B = clip3d.shape[0]
        kcs = kcs_features(clip3d, with_lengths=False)               # (B, F, 15)
        branches = [self.kcs_tower(kcs.reshape(B, F_ * 15)),
                    self.kcs_diff_tower(temporal_diff(kcs).reshape(B, (F_ - 1) * 15))]
        if self.pose_tower is not None:
            branches.append(self.pose_tower(clip3d.reshape(B, F_ * 48)))
        if self.pose_diff_tower is not None:
            diff3d = temporal_diff(clip3d.reshape(B, F_, 48))
            branches.append(self.pose_diff_tower(diff3d.reshape(B, (F_ - 1) * 48)))
        return self.out(self.merge_block(self.merge(torch.cat(branches, dim=-1))))


class MotionFk2DDiscriminator(nn.Module):
    """Motion 2D critic over clips (B, F, 16, 2): a raw-2D tower (F x 32) and
    a tower on the root trajectory's frame-to-frame steps ((F-1) x 2)."""

    role = "md2d"  # its updates are traced as gan.critic.md2d

    def __init__(self, video_frames: int, dense_dim: int = 1000):  # --video_Dis_DenseDim_2D
        super().__init__()
        F_ = self.video_frames = video_frames
        self.pose_tower = ResTower(F_ * 32, dense_dim)
        self.root_diff_tower = ResTower((F_ - 1) * 2, dense_dim)
        self.merge = DensePrelude(2 * dense_dim, 100)
        self.merge_block = DenseResBlock(100)
        self.out = dense(100, 1)

    def forward(self, clip2d: torch.Tensor) -> torch.Tensor:
        F_ = self.video_frames
        clip2d = clip2d.reshape(-1, F_, 16, 2)
        B = clip2d.shape[0]
        root_diff = temporal_diff(clip2d[:, :, 0, :]).reshape(B, (F_ - 1) * 2)
        merged = torch.cat([self.pose_tower(clip2d.reshape(B, F_ * 32)),
                            self.root_diff_tower(root_diff)], dim=-1)
        return self.out(self.merge_block(self.merge(merged)))
