"""Bulk pose synthesis: the body of FK-GAN sampling, on one device or
spread over the ranks of a process group.

Port of ``dhaug_tpu/parallel/sharded.py::make_sharded_synthesizer``
(``:18-73``): noise -> generator trunk (kernel B3 on the card) -> bone
scalers -> FK (kernel B1 on the card).  Over N devices the batch is cut
into N shards, each with a random stream of its own, as each JAX shard
folds its mesh position into the key (``:61-63``): a rank of a group of N
runs its own shard's body on its device and nothing else, with no
collective; outside a group the N shards run one after another in this
process, which gives the same rows.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dhaug_torch.models.generator import GeneratorConfig, fk_operands, sample_scaler8
from dhaug_torch.models.trunk_cuda import trunk_forward
from dhaug_torch.ops import fk_cuda
from dhaug_torch.parallel import mesh
from dhaug_torch.utils.profiling import span


def stream(device, *key: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integers ``key``
    (for example (seed, batch index, shard)) through numpy's SeedSequence."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0]))
    return g


def make_sharded_synthesizer(gen_cfg: GeneratorConfig, n_devices: int = 1) -> Callable:
    """Bulk pose synthesis.  With one device it returns ``synthesize(ops,
    bone_len (B, 15), generator, noise=None, scaler8=None) -> world poses
    (B, 16, 3)``, where ``ops`` are the trunk operands of
    ``models.trunk_cuda.trunk_weights`` and ``generator`` is a
    ``torch.Generator`` on ``bone_len``'s device.  Bone scalers are drawn
    per group ('different', the synthesis CLI's mode).  ``noise`` (B,
    gen_cfg.noise_dim) and ``scaler8`` (B, 8) replace the draws, so tests
    can feed both packages the same numbers.

    With ``n_devices`` N > 1 the batch B (divisible by N) is N shards of
    B/N rows and ``generator`` is a sequence of N generators, shard s
    drawing from the s-th.  A rank of a group of N ranks synthesizes its
    own shard and returns its B/N rows; outside a group every shard is
    synthesized here in turn and the B rows come back in shard order."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")

    @torch.no_grad()
    def body(ops, bone_len: torch.Tensor, generator: Optional[torch.Generator],
             noise: Optional[torch.Tensor] = None,
             scaler8: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = bone_len.shape[0]
        with span("synth.trunk"):
            if noise is None:
                noise = torch.randn((B, gen_cfg.noise_dim), generator=generator,
                                    device=bone_len.device)
            head = trunk_forward(ops, noise)
        with span("synth.angles"):
            if scaler8 is None:
                scaler8 = sample_scaler8(B, "different", generator, bone_len.device)
            operands = fk_operands(head, bone_len, scaler8, gen_cfg)
        with span("synth.fk"):
            pose16 = fk_cuda.fk_world_pose_16(*operands)
        F = gen_cfg.video_frames
        return pose16 if F == 1 else pose16.reshape(B, F, 16, 3)

    if n_devices == 1:
        return body

    def synthesize(ops, bone_len: torch.Tensor, generators: Sequence[torch.Generator],
                   noise: Optional[torch.Tensor] = None,
                   scaler8: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = bone_len.shape[0]
        if B % n_devices or len(generators) != n_devices:
            raise ValueError(f"{n_devices} shards need a batch divisible by {n_devices} "
                             f"and {n_devices} generators; got B = {B} and "
                             f"{len(generators)} generators")
        dp = mesh.current()
        if dp.group is not None and dp.world != n_devices:
            raise ValueError(f"a synthesizer of {n_devices} shards in a group of "
                             f"{dp.world} ranks")
        n = B // n_devices
        shards = [dp.rank] if dp.group is not None else range(n_devices)
        cut = lambda t, s: None if t is None else t[s * n:(s + 1) * n]
        return torch.cat([body(ops, cut(bone_len, s), generators[s], cut(noise, s),
                               cut(scaler8, s)) for s in shards])

    return synthesize
