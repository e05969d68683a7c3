"""Quaternion rotation ops on tensors (any leading shape, differentiable).

Port of ``dhaug_tpu/ops/quaternion.py``: rotate vectors by unit quaternions
(w, x, y, z) and invert unit quaternions.
"""
from __future__ import annotations

import torch


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` (..., 3) by unit quaternion(s) ``q`` (..., 4); leading
    dims broadcast.  Cross-product form v + 2*(w*(qv x v) + qv x (qv x v))."""
    shape = torch.broadcast_shapes(q.shape[:-1], v.shape[:-1])
    q = q.expand(shape + (4,))
    v = v.expand(shape + (3,))
    w = q[..., :1]
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def qinverse(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion: (w, -x, -y, -z)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
