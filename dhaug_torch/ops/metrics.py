"""Pose metrics: MPJPE (whole, by joint, weighted), Procrustes-aligned MPJPE
(P-MPJPE), scale-normalized MPJPE, velocity error, PCK and AUC, and the two
rectified L2 losses.

Port of ``dhaug_tpu/ops/metrics.py``.  Metres in, metres out (callers
scale to mm); PCK and AUC take metres and return percent, at the 3DHP
protocol's 150 mm and 31 thresholds in [0, 150] mm.  P-MPJPE uses a batched
SVD of the (N, 3, 3) cross-covariances.
"""
from __future__ import annotations

import torch


def mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error ("Protocol #1")."""
    return torch.mean(torch.linalg.vector_norm(predicted - target, dim=-1))


def mpjpe_by_joint(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE of each joint, averaged over the first axis."""
    return torch.mean(torch.linalg.vector_norm(predicted - target, dim=-1), dim=0)


def weighted_mpjpe(predicted: torch.Tensor, target: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """MPJPE with each joint error multiplied by ``w`` (broadcast)."""
    return torch.mean(w * torch.linalg.vector_norm(predicted - target, dim=-1))


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


def p_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE after the per-sample similarity alignment ("Protocol #2")."""
    return torch.mean(p_mpjpe_per_sample(predicted, target))


def n_mpjpe(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MPJPE after the optimal per-sample scale of the prediction."""
    norm_predicted = torch.mean(torch.sum(predicted ** 2, dim=-1, keepdim=True), dim=-2,
                                keepdim=True)
    norm_target = torch.mean(torch.sum(target * predicted, dim=-1, keepdim=True), dim=-2,
                             keepdim=True)
    return mpjpe(norm_target / norm_predicted * predicted, target)


def mean_velocity_error(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean error of the frame-to-frame velocities (first axis is time)."""
    return torch.mean(torch.linalg.vector_norm(torch.diff(predicted, dim=0)
                                               - torch.diff(target, dim=0), dim=-1))


def compute_pck(gts: torch.Tensor, preds: torch.Tensor, scale: float = 1000.0,
                threshold: float = 150.0) -> torch.Tensor:
    """Percentage of joints whose error, times ``scale`` (m -> mm), is below
    ``threshold``."""
    err = torch.linalg.vector_norm(preds - gts, dim=-1) * scale
    return torch.mean((err < threshold).float()) * 100.0


def compute_auc(gts: torch.Tensor, preds: torch.Tensor, scale: float = 1000.0) -> torch.Tensor:
    """Mean PCK over 31 thresholds in [0, 150] mm."""
    err = torch.linalg.vector_norm(preds - gts, dim=-1) * scale
    thresholds = torch.linspace(0.0, 150.0, 31, dtype=err.dtype, device=err.device)
    # every threshold's PCK averages the same joints: one mean over both
    return torch.mean((err.reshape(-1, 1) < thresholds).float()) * 100.0


def diff_range_loss(a: torch.Tensor, b: torch.Tensor, std) -> torch.Tensor:
    """Rectified L2 on (a - b): zero inside +-std, the squared error outside."""
    diff = (a - b) ** 2
    return torch.mean(diff * (diff > std ** 2).to(diff.dtype))


def rectified_l2_loss(gamma: torch.Tensor, threshold) -> torch.Tensor:
    """gamma squared where |gamma| exceeds ``threshold``, else 0, averaged."""
    diff = gamma ** 2
    return torch.mean(diff * (diff > threshold ** 2).to(diff.dtype))
