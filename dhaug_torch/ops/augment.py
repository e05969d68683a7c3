"""Left/right flip of 16-joint poses and clips, the flip of a camera's
intrinsics, and time reversal (port of ``dhaug_tpu/ops/augment.py``)."""
from __future__ import annotations

import numpy as np
import torch

from dhaug_torch.data.h36m import JOINTS_LEFT_16, JOINTS_RIGHT_16

# permutation that swaps left<->right 16-joint slots
_FLIP_PERM = np.arange(16)
for _l, _r in zip(JOINTS_LEFT_16, JOINTS_RIGHT_16):
    _FLIP_PERM[_l], _FLIP_PERM[_r] = _r, _l
FLIP_PERM = tuple(int(i) for i in _FLIP_PERM)


def flip_pose(pose: torch.Tensor) -> torch.Tensor:
    """Mirror a 16-joint pose (..., 16, C) in x and swap left/right joints.
    Works for 2D and 3D."""
    flipped = torch.cat([-pose[..., :1], pose[..., 1:]], dim=-1)
    perm = torch.as_tensor(FLIP_PERM, device=pose.device)
    return flipped.index_select(-2, perm)


def flip_intrinsics(cam: torch.Tensor) -> torch.Tensor:
    """Negate principal-point x and tangential-distortion x for a flipped
    image (video_mode_operate.py:172-174).  cam (..., >=9)."""
    sign = torch.ones(cam.shape[-1], dtype=cam.dtype, device=cam.device)
    sign[2] = -1.0
    sign[7] = -1.0
    return cam * sign


def time_reverse(clip: torch.Tensor) -> torch.Tensor:
    """Reverse the frame axis of (..., F, J, C) clips: the 'playback'
    augmentation (video_GAN_fun.py:219-232)."""
    return torch.flip(clip, dims=(-3,))
