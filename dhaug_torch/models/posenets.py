"""The MLP posenet (Martinez et al.): port of ``LinearModel`` and
``_LinearStage`` from ``dhaug_tpu/models/posenets.py``.

``nn.BatchNorm1d`` with momentum 0.1 and eps 1e-5 already has the semantics
the JAX package had to write by hand: it normalizes with the biased batch
variance and updates the running variance with the unbiased one.

Dropout draws from an explicit ``torch.Generator`` passed to ``forward`` (on
the tensors' device), so a run is reproducible from its seed; without one it
falls back to torch's default generator.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from dhaug_torch.models.blocks import dense


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    if not training or p == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


def batch_norm(dim: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(dim, eps=1e-5, momentum=0.1)


def pad_hip(out15: torch.Tensor) -> torch.Tensor:
    """(B, 45) 15-joint prediction -> (B, 16, 3) with a zero hip at joint 0."""
    B = out15.shape[0]
    return torch.cat([out15.new_zeros(B, 3), out15], dim=1).reshape(B, 16, 3)


class _LinearStage(nn.Module):
    def __init__(self, dim: int, p_dropout: float):
        super().__init__()
        self.fc1 = dense(dim, dim)
        self.bn1 = batch_norm(dim)
        self.fc2 = dense(dim, dim)
        self.bn2 = batch_norm(dim)
        self.p_dropout = p_dropout

    def forward(self, x, generator=None):
        y = dropout(F.relu(self.bn1(self.fc1(x))), self.p_dropout, self.training, generator)
        y = dropout(F.relu(self.bn2(self.fc2(y))), self.p_dropout, self.training, generator)
        return x + y


class LinearModel(nn.Module):
    """16x2 -> linear_size -> num_stage residual stages -> 15x3, hip padded."""

    def __init__(self, linear_size: int = 1024, num_stage: int = 2,
                 p_dropout: float = 0.5):
        super().__init__()
        self.fc_in = dense(32, linear_size)
        self.bn_in = batch_norm(linear_size)
        self.stages = nn.ModuleList(_LinearStage(linear_size, p_dropout)
                                    for _ in range(num_stage))
        self.fc_out = dense(linear_size, 45)
        self.p_dropout = p_dropout

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        x = x.reshape(x.shape[0], 32)
        y = dropout(F.relu(self.bn_in(self.fc_in(x))), self.p_dropout, self.training,
                    generator)
        for stage in self.stages:
            y = stage(y, generator)
        return pad_hip(self.fc_out(y))
