"""Camera model: world<->camera and the H36M projection, on tensors.

Port of the parts of ``dhaug_tpu/ops/camera.py`` the single-frame path uses.
2D coordinates live in the reference's aspect-preserving normalized screen
space [-1, 1] x [-h/w, h/w].
"""
from __future__ import annotations

import torch

from dhaug_torch.ops.quaternion import qinverse, qrot


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
