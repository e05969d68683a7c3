"""Pose metrics: MPJPE and per-sample Procrustes-aligned MPJPE (P-MPJPE).

Port of ``dhaug_tpu/ops/metrics.py:17-66``.  Metres in, metres out; callers
scale to mm.  P-MPJPE uses a batched SVD of the (N, 3, 3) cross-covariances.
"""
from __future__ import annotations

import torch


def mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error ("Protocol #1")."""
    return torch.mean(torch.linalg.vector_norm(predicted - target, dim=-1))


def p_mpjpe_per_sample(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample MPJPE after the optimal similarity alignment (scale,
    rotation, translation) of ``predicted`` onto ``target``; (N, J, 3) -> (N,)."""
    muX = target.mean(dim=1, keepdim=True)
    muY = predicted.mean(dim=1, keepdim=True)
    X0 = target - muX
    Y0 = predicted - muY
    normX = torch.sqrt(torch.sum(X0 ** 2, dim=(1, 2), keepdim=True))
    normY = torch.sqrt(torch.sum(Y0 ** 2, dim=(1, 2), keepdim=True))
    X0 = X0 / normX
    Y0 = Y0 / normY

    H = X0.transpose(1, 2) @ Y0
    U, s, Vt = torch.linalg.svd(H)
    V = Vt.transpose(1, 2)
    R = V @ U.transpose(1, 2)
    # reflection fix: flip the last singular direction where det(R) < 0
    sign_detR = torch.sign(torch.linalg.det(R))
    V = torch.cat([V[:, :, :-1], V[:, :, -1:] * sign_detR[:, None, None]], dim=2)
    s = torch.cat([s[:, :-1], s[:, -1:] * sign_detR[:, None]], dim=1)
    R = V @ U.transpose(1, 2)

    tr = s.sum(dim=1, keepdim=True)[:, :, None]
    a = tr * normX / normY
    t = muX - a * (muY @ R)
    aligned = a * (predicted @ R) + t
    return torch.mean(torch.linalg.vector_norm(aligned - target, dim=-1), dim=-1)
