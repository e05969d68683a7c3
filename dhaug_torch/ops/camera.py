"""Camera model: screen normalization, world<->camera and the H36M
projection, on tensors.

Port of ``dhaug_tpu/ops/camera.py``.  2D coordinates live in the
reference's aspect-preserving normalized screen space [-1, 1] x [-h/w, h/w].
"""
from __future__ import annotations

import torch

from dhaug_torch.ops.quaternion import qinverse, qrot


def normalize_screen_coordinates(points: torch.Tensor, w: float, h: float) -> torch.Tensor:
    """Pixel coords -> normalized coords in [-1, 1] x [-h/w, h/w].  (..., 2)."""
    x = points[..., 0] / w * 2.0 - 1.0
    y = points[..., 1] / w * 2.0 - h / w
    return torch.stack([x, y], dim=-1)


def image_coordinates(points: torch.Tensor, w: float, h: float) -> torch.Tensor:
    """Inverse of :func:`normalize_screen_coordinates`.  (..., 2)."""
    x = (points[..., 0] + 1.0) * w / 2.0
    y = (points[..., 1] + h / w) * w / 2.0
    return torch.stack([x, y], dim=-1)


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


def unit_ratio(X: torch.Tensor) -> torch.Tensor:
    """The perspective divide ``X[..., :2] / X[..., 2:]`` clamped by
    :func:`clip_unit`.

    A point at a depth of exactly 0 (a float32 sum can cancel to it) divides
    to +-inf, which the clamp takes to +-1 and whose gradient the clamp
    zeroes; but the divide's own gradient there is inf, and 0 x inf is NaN,
    which one Adam step spreads over every weight of the generator.  Where
    the gradient is taken, such a point is divided by a depth the gradient
    does not see: the same value, and the clamp's gradient of 0, as at
    every point outside it.  Elsewhere values and gradients are the plain
    divide's.
    """
    xy, z = X[..., :2], X[..., 2:]
    if not (torch.is_grad_enabled() and X.requires_grad):
        return clip_unit(xy / z)
    flat = z == 0
    return clip_unit(torch.where(flat, xy.detach() / z.detach(),
                                 xy / torch.where(flat, torch.ones_like(z), z)))


def project_to_2d(X: torch.Tensor, camera_params: torch.Tensor) -> torch.Tensor:
    """Project camera-space 3D points through the full H36M camera model.

    X: (N, ..., 3); camera_params: (N, 9) = [f(2), c(2), k(3), p(2)] (only
    [:9] of a longer record is read).  The perspective divide is clamped to
    [-1, 1] as the reference does (common/camera.py:85), by
    :func:`unit_ratio`.
    """
    params = camera_params[..., :9]
    while params.ndim < X.ndim:
        params = params[:, None]
    f = params[..., :2]
    c = params[..., 2:4]
    k = params[..., 4:7]
    p = params[..., 7:9]

    XX = unit_ratio(X)
    r2 = torch.sum(XX ** 2, dim=-1, keepdim=True)
    radial = 1.0 + torch.sum(k * torch.cat([r2, r2 ** 2, r2 ** 3], dim=-1),
                             dim=-1, keepdim=True)
    tan = torch.sum(p * XX, dim=-1, keepdim=True)
    XXX = XX * (radial + tan) + p * r2
    return f * XXX + c


def project_to_2d_linear(X: torch.Tensor, camera_params: torch.Tensor) -> torch.Tensor:
    """Pinhole-only projection (focal length + principal point), the divide
    clamped to [-1, 1] as in :func:`project_to_2d`."""
    params = camera_params[..., :9]
    while params.ndim < X.ndim:
        params = params[:, None]
    return params[..., :2] * unit_ratio(X) + params[..., 2:4]
