"""FK-GAN generator: noise -> 35-d head -> angles + root -> DH-FK -> pose.

Port of ``dhaug_tpu/models/generator.py``.  The head layout quirk is kept:
the head emits 35 values a frame, [0:31] fill the 31 non-structurally-zero
slots of the 37-d [34 DOF + 3 global rotation] vector in order, value 31 is
unused, and [32:35] are the root (tanh x 10).  The video generator
(``video_frames`` F > 1) emits all F frames of a clip from one noise vector,
a head of F x 35.  ``bf16_trunk`` (``--bf16_trunk``) runs the trunk's
matmuls, bias adds, ReLUs and residual adds in bf16 with fp32 parameters,
as flax's ``dtype=bfloat16`` does, and casts the head back to fp32; FK and
geometry stay fp32.  It is plain bf16 ``F.linear`` (cuBLAS on the card),
not the trunk kernel B3, whose biases and residuals stay fp32.

:func:`synthesize_poses` routes the FK through ``ops/fk_cuda`` (the CUDA
kernels for CUDA tensors, the plain FK for CPU tensors).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from dhaug_torch.models.blocks import DensePrelude, DenseResBlock, apply_dense, dense
from dhaug_torch.ops import fk_cuda

# Structurally-zero DOF slots (Fk_generator.py:136).
ZERO_SLOTS = (4, 9, 22, 23, 28, 33)
NONZERO_SLOTS = tuple(i for i in range(37) if i not in ZERO_SLOTS)  # 31 slots

# GAN per-joint angle ranges + global rotation (Fk_generator.py:35-76), as
# (lo, hi) over the 37-d vector.
_GAN_RANGES = (
    (-110, 65), (-110, 65), (-110, 180), (-180, 0), (0, 0),
    (-65, 110), (-65, 110), (-110, 180), (-180, 0), (0, 0),
    (-180, 180), (-180, 180), (-180, 180), (-180, 180), (-180, 180),
    (-180, 180), (-180, 180), (-180, 180), (-180, 180), (-180, 180),
    (-180, 180), (-180, 180), (0, 0), (0, 0),
    (-155, 65), (-155, 65), (-100, 180), (0, 180), (0, 0),
    (-65, 155), (-65, 155), (-100, 180), (0, 180), (0, 0),
    (-180, 180), (-180, 180), (-180, 180),
)
GAN_RANGE_LO = np.array([lo for lo, _ in _GAN_RANGES], np.float32)
GAN_RANGE_HI = np.array([hi for _, hi in _GAN_RANGES], np.float32)
GAN_RANGE_SCALE = (GAN_RANGE_HI - GAN_RANGE_LO) / 2.0
GAN_RANGE_MID = (GAN_RANGE_HI + GAN_RANGE_LO) / 2.0

# 8 mirrored bone-scaler groups -> 15 FK bones; thorax (bone 7) is never
# scaled (Fk_generator.py:216-230).
_SCALER_GROUPS = np.zeros((8, 15), np.float32)
for _bone, _group in enumerate([0, 0, 1, 1, 2, 2, 3, -1, 4, 4, 5, 5, 6, 6, 7]):
    if _group >= 0:
        _SCALER_GROUPS[_group, _bone] = 1.0

_TABLES = {"slots": NONZERO_SLOTS, "range_scale": GAN_RANGE_SCALE,
           "range_mid": GAN_RANGE_MID, "scaler_groups": _SCALER_GROUPS}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device, dtype=None) -> torch.Tensor:
    """The constant table ``name`` on ``device`` (a tensor's device, so a
    CUDA one names its card), uploaded on its first use there and shared
    read-only afterwards: a pageable host-to-device copy synchronizes the
    stream, which a synthesis dispatch must not."""
    return torch.as_tensor(_TABLES[name], dtype=dtype, device=device)


class GeneratorConfig(NamedTuple):
    dense_dim: int = 1000          # --Gen_DenseDim
    output_dim: int = 35           # --GAN_OUTPUT_DIM
    noise_dim: int = 128
    use_pre_angle: bool = True     # --GAN_whether_use_preAngle
    use_global_rot: bool = True    # --whether_use_RT
    video_frames: int = 1          # F > 1: the video generator
    bf16_trunk: bool = False       # --bf16_trunk: the trunk computes in bf16


class FkGeneratorNet(nn.Module):
    """The dense trunk: noise (B, 128) -> head (B, F x 35), fp32."""

    def __init__(self, cfg: GeneratorConfig):
        super().__init__()
        self.dtype = torch.bfloat16 if cfg.bf16_trunk else None
        self.prelude = DensePrelude(cfg.noise_dim, cfg.dense_dim, self.dtype)
        self.blocks = nn.ModuleList(DenseResBlock(cfg.dense_dim, self.dtype)
                                    for _ in range(3))
        self.head = dense(cfg.dense_dim, cfg.video_frames * cfg.output_dim)

    def forward(self, noise):
        x = self.prelude(noise)
        for block in self.blocks:
            x = block(x)
        return apply_dense(self.head, x, self.dtype).float()


def head_to_angles(head: torch.Tensor, cfg: GeneratorConfig):
    """Raw head (..., 35) -> (angles37 in degrees, root (..., 3)): tanh, the
    31-slot scatter, the per-joint range rescale (or x180), and the
    use_global_rot gate."""
    squashed = torch.tanh(head)
    root = squashed[..., 32:35] * 10.0
    vals31 = squashed[..., :31]
    angles37 = head.new_zeros(head.shape[:-1] + (37,))
    angles37 = angles37.index_copy(-1, _table("slots", head.device), vals31)
    if cfg.use_pre_angle:
        # x * (hi-lo)/2 + (hi+lo)/2; zero-range slots have scale = mid = 0
        angles37 = (angles37 * _table("range_scale", head.device)
                    + _table("range_mid", head.device))
    else:
        angles37 = angles37 * 180.0
    if not cfg.use_global_rot:
        angles37 = torch.cat([angles37[..., :34], torch.zeros_like(angles37[..., 34:])], -1)
    return angles37, root


def scale_bone_lengths(bone_len: torch.Tensor, scaler8: torch.Tensor) -> torch.Tensor:
    """new = len * (1 + group ratio); bone_len (..., 15) FK order, scaler8
    (..., 8) in [-0.2, 0.2]."""
    groups = _table("scaler_groups", scaler8.device, scaler8.dtype)
    ratio15 = torch.einsum("gb,...g->...b", groups, scaler8)
    return bone_len * (1.0 + ratio15)


def fk_operands(head: torch.Tensor, bone_len: torch.Tensor, scaler8: torch.Tensor,
                cfg: GeneratorConfig) -> tuple:
    """The FK's operands for the head output's B x F poses: (angles (BF, 33),
    scaled bone lengths (BF, 15), global rotation (BF, 3), root (BF, 3))."""
    B, F = head.shape[0], cfg.video_frames
    angles37, root = head_to_angles(head.reshape(B * F, cfg.output_dim), cfg)
    scaled_bl = scale_bone_lengths(bone_len, scaler8)
    if F > 1:
        scaled_bl = scaled_bl.repeat_interleave(F, dim=0)
    return (angles37[:, :33].contiguous(), scaled_bl.contiguous(),
            angles37[:, 34:37].contiguous(), root.contiguous())


def synthesize_poses(head: torch.Tensor, bone_len: torch.Tensor,
                     scaler8: torch.Tensor, cfg: GeneratorConfig) -> torch.Tensor:
    """World poses from the head output (B, F x 35), FK-order bone lengths
    (B, 15) and the bone scalers (B, 8), which a clip's F frames share
    (Fk_generator.py:383-390): (B, 16, 3) for F == 1, else (B, F, 16, 3).
    The B x F poses go through one FK call."""
    B, F = head.shape[0], cfg.video_frames
    pose16 = fk_cuda.fk_world_pose_16(*fk_operands(head, bone_len, scaler8, cfg))
    return pose16 if F == 1 else pose16.reshape(B, F, 16, 3)


def sample_scaler8(batch_size: int, mode: str, generator: torch.Generator,
                   device) -> torch.Tensor:
    """Bone-length scaler ratios (--bone_len_scaler): 'different' draws each
    group independently, 'same' one ratio for all groups, '' zeros.  Ratios
    are uniform over {-0.200 .. 0.199} like randint(-200, 200) / 1000."""
    if mode == "different":
        ints = torch.randint(-200, 200, (batch_size, 8), generator=generator, device=device)
        return ints.float() / 1000.0
    if mode == "same":
        ints = torch.randint(-200, 200, (batch_size, 1), generator=generator, device=device)
        return (ints.float() / 1000.0).expand(batch_size, 8).contiguous()
    if mode == "":
        return torch.zeros((batch_size, 8), device=device)
    raise ValueError(f"bone_len_scaler mode {mode!r}")
