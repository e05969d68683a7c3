"""Bulk pose synthesis: the body of FK-GAN sampling on one device.

Port of the single-device body of ``dhaug_tpu/parallel/sharded.py::
make_sharded_synthesizer`` (``:18-51``): noise -> generator trunk (kernel
B3 on the card) -> bone scalers -> FK (kernel B1 on the card).  Spreading
the batch over several cards is ROADMAP A16 and raises here.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from dhaug_torch.models.generator import GeneratorConfig, sample_scaler8, synthesize_poses
from dhaug_torch.models.trunk_cuda import trunk_forward


def make_sharded_synthesizer(gen_cfg: GeneratorConfig, n_devices: int = 1) -> Callable:
    """Bulk pose synthesis: returns ``synthesize(ops, bone_len (B, 15),
    generator, noise=None, scaler8=None) -> world poses (B, 16, 3)``, where
    ``ops`` are the trunk operands of ``models.trunk_cuda.trunk_weights``
    and ``generator`` is a ``torch.Generator`` on ``bone_len``'s device.
    Bone scalers are drawn per group ('different', the synthesis CLI's
    mode).  ``noise`` (B, gen_cfg.noise_dim) and ``scaler8`` (B, 8) replace
    the draws, so tests can feed both packages the same numbers."""
    if n_devices != 1:
        raise NotImplementedError(
            f"synthesis over {n_devices} devices is not ported yet to dhaug_torch "
            "(ROADMAP A16, multi-GPU); run on one device")

    @torch.no_grad()
    def synthesize(ops, bone_len: torch.Tensor, generator: Optional[torch.Generator],
                   noise: Optional[torch.Tensor] = None,
                   scaler8: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = bone_len.shape[0]
        if noise is None:
            noise = torch.randn((B, gen_cfg.noise_dim), generator=generator,
                                device=bone_len.device)
        head = trunk_forward(ops, noise)
        if scaler8 is None:
            scaler8 = sample_scaler8(B, "different", generator, bone_len.device)
        return synthesize_poses(head, bone_len, scaler8, gen_cfg)

    return synthesize
