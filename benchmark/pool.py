"""The benchmark's training data and seeds, made on the device from ``--seed``.

The pool stands in for the H36M training split that DH-AUG trains on
(subjects S1, S5, S6, S7 and S8 seen through their four cameras): a set of
motion sequences of ``sequence_frames`` frames each, every one a person of
its own bone lengths (uniform within the range of the H36M bone-length
templates) moving smoothly through the DH model's joint ranges, seen
through one of the 20 training cameras.  Each frame is the camera-space
3D pose (16, 3) in metres, its projection through the camera's distortion
model (16, 2) in normalized screen units, and the camera record (16):
intrinsic(9) | quaternion(4) | translation(3).  It is synthetic and is
not H36M; its size is.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import geometry as geo
from benchmark.reference.cameras import camera_records
from benchmark.reference.steps import ANGLE_RANGES

FPS = 50.0
FK_BLOCK = 1 << 18


def seeds(seed: int, n: int = 8) -> list:
    """``n`` independent 63-bit seeds drawn from ``seed`` (any whole number)."""
    return [int(s) for s in np.random.SeedSequence(abs(int(seed))).generate_state(n, np.uint64)
            % (1 << 63)]


def torch_generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def tree_to_fk_order() -> list:
    """Index of each FK-order bone in the kinematic-tree order."""
    tree = [frozenset(b) for b in geo.H36M_TREE_BONES]
    return [tree.index(frozenset(b)) for b in geo.USED_16KEY_15BONE_TABLE]


class Pool(NamedTuple):
    cam3d: torch.Tensor      # (N, 16, 3)
    pose2d: torch.Tensor     # (N, 16, 2)
    cam16: torch.Tensor      # (N, 16)
    sequence_frames: int

    @property
    def n_sequences(self) -> int:
        return self.cam3d.shape[0] // self.sequence_frames


def bone_templates(params: dict, generator: torch.Generator, n: int = 200) -> torch.Tensor:
    """(n, 15) tree-order bone-length templates, uniform within the range."""
    lo = torch.tensor(params["bone_length_lo_tree"], device=generator.device)
    hi = torch.tensor(params["bone_length_hi_tree"], device=generator.device)
    u = torch.rand((n, 15), generator=generator, device=generator.device)
    return lo + u * (hi - lo)


@torch.no_grad()
def make_pool(params: dict, generator: torch.Generator) -> Pool:
    """The pool of ``params["frames"]`` frames (cut to whole sequences)."""
    device = generator.device
    L = int(params["sequence_frames"])
    S = int(params["frames"]) // L
    rand = lambda *shape: torch.rand(shape, generator=generator, device=device)
    lo = torch.tensor([r[0] for r in ANGLE_RANGES[:33]], device=device, dtype=torch.float32)
    hi = torch.tensor([r[1] for r in ANGLE_RANGES[:33]], device=device, dtype=torch.float32)
    half, mid = (hi - lo) / 2, (hi + lo) / 2
    # per sequence and chain angle: centre, amplitude, frequency (Hz), phase
    centre = mid + (rand(S, 33) - 0.5) * half
    amp = rand(S, 33) * 0.3 * half
    freq = 0.1 + 0.9 * rand(S, 33)
    phase = rand(S, 33) * 2 * math.pi
    # per sequence: tilt, yaw and its rate, root centre and sway
    tilt = (rand(S, 2) - 0.5) * 20.0
    yaw0, yaw_rate = rand(S) * 360.0 - 180.0, (rand(S) - 0.5) * 40.0
    root0 = torch.stack([rand(S) * 2 - 1, rand(S) * 2 - 1, 0.95 + 0.1 * rand(S)], -1)
    sway, sway_freq, sway_phase = 0.5 * rand(S, 3), 0.02 + 0.08 * rand(S, 3), rand(S, 3) * 6.3
    sway[:, 2] *= 0.06
    bones_tree = bone_templates(params, generator, S)
    bones_fk = bones_tree[:, tree_to_fk_order()]
    cams = torch.as_tensor(camera_records(), device=device)[
        torch.randint(0, 20, (S,), generator=generator, device=device)]

    t = torch.arange(L, device=device, dtype=torch.float32) / FPS            # (L,)
    cam3d = torch.empty((S * L, 16, 3), device=device)
    pose2d = torch.empty((S * L, 16, 2), device=device)
    per_block = max(1, FK_BLOCK // L)
    for s0 in range(0, S, per_block):
        s = slice(s0, min(S, s0 + per_block))
        n = s.stop - s.start
        ang = centre[s, None] + amp[s, None] * torch.sin(
            2 * math.pi * freq[s, None] * t[None, :, None] + phase[s, None])
        ang = torch.maximum(torch.minimum(ang, hi), lo)                        # (n, L, 33)
        yaw = yaw0[s, None] + yaw_rate[s, None] * t[None]
        grot = torch.cat([tilt[s, None].expand(n, L, 2), yaw[..., None]], -1)
        root = root0[s, None] + sway[s, None] * torch.sin(
            2 * math.pi * sway_freq[s, None] * t[None, :, None] + sway_phase[s, None])
        world = geo.fk_world_pose_16(ang.reshape(-1, 33),
                                     bones_fk[s, None].expand(n, L, 15).reshape(-1, 15),
                                     grot.reshape(-1, 3), root.reshape(-1, 3))
        cam = cams[s, None].expand(n, L, 16).reshape(-1, 16)
        c3 = geo.world_to_camera_batch(world, cam[:, 9:13], cam[:, 13:16])
        rows = slice(s.start * L, s.stop * L)
        cam3d[rows] = c3
        pose2d[rows] = geo.project_to_2d(c3, cam[:, :9])
    return Pool(cam3d, pose2d, cams.repeat_interleave(L, dim=0), L)
