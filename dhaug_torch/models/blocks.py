"""Shared dense building blocks of the GAN nets and the MLP posenet.

Port of ``dhaug_tpu/models/blocks.py``.  Initialisation mirrors flax's
``he_normal``: a normal truncated at two standard deviations, fan-in, scale
2, with the standard deviation corrected for the truncation; biases zero.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling divides
# by it so the truncated draw keeps the intended variance)
_TRUNC_STD = 0.87962566103423978


def he_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax ``he_normal`` on a torch (out, in) weight."""
    fan_in = weight.shape[1]
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def dense(in_dim: int, out_dim: int) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim)
    he_normal_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class DenseResBlock(nn.Module):
    """relu(W2 relu(W1 x) + x): the reference's ``myResNet``."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = dense(dim, dim)
        self.fc2 = dense(dim, dim)

    def forward(self, x):
        return F.relu(self.fc2(F.relu(self.fc1(x))) + x)


class DensePrelude(nn.Module):
    """Dense + ReLU input adapter."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.fc = dense(in_dim, dim)

    def forward(self, x):
        return F.relu(self.fc(x))


class ResTower(nn.Module):
    """Prelude + ``blocks`` residual blocks: the critic branch shape."""

    def __init__(self, in_dim: int, dim: int, blocks: int = 3):
        super().__init__()
        self.prelude = DensePrelude(in_dim, dim)
        self.blocks = nn.ModuleList(DenseResBlock(dim) for _ in range(blocks))

    def forward(self, x):
        x = self.prelude(x)
        for block in self.blocks:
            x = block(x)
        return x
