"""PoseFormer in plain PyTorch, float32, for the benchmark's reference.

Zheng et al., "3D Human Pose Estimation with Spatial and Temporal
Transformers" (ICCV 2021, arXiv:2103.10455), as DH-AUG trains it under
``--posenet_name mulit_farme_poseformer``
(models_baseline/poseformer/model_poseformer.py, ``PoseTransformer``):

* each frame's J joints -> ``Linear(2, C)`` + a learned joint embedding,
  then ``depth`` pre-norm blocks over the J tokens at width C;
* the frames' J x C embeddings, flattened to E = J x C, + a learned frame
  embedding, then ``depth`` pre-norm blocks over the F tokens at width E;
* a block is x + DropPath(Attn(LN(x))), then x + DropPath(MLP(LN(x))),
  LayerNorm eps 1e-6, attention softmax(Q K^T / sqrt(d)) V from one
  ``qkv`` projection with heads of d = width / heads, MLP fc1 -> exact
  GELU -> fc2 at ``mlp_ratio`` x the width;
* stochastic depth rising linearly from 0 to ``drop_path_rate`` over the
  blocks (the same rate at one depth in both transformers), dropping a
  whole sample's residual branch;
* the frames' weighted mean, ``Conv1d(F, 1, 1)``, then a LayerNorm at
  eps 1e-5 (torch's default, not the blocks') and ``Linear(E, J x 3)``:
  the centre frame's pose.

Departures from the published model, each the program's too: the
attention and MLP dropouts are not built, since DH-AUG leaves their rate
at 0 (its ``--dropout`` flag does not reach PoseFormer); each stochastic
depth mask is one Bernoulli draw of shape (rows, 1, 1) from the run's
``torch.Generator``, in the order the blocks run (a block at rate 0 draws
nothing), so that both sides drop the same branches; the weights are the
benchmark's seeded draw, not timm's truncated normal.

Parameters are registered in the program's order under the published
``state_dict`` names, so that one draw of :func:`nets.init_weights` gives
both sides the same weights.  Every product goes through
:func:`nets.linear` or :func:`nets.conv1d`, and the attention's two
batched products through :func:`matmul`: in a net :func:`use_tf32` marked,
each of them rounds its operands to TF32, forward and backward.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference import nets


def use_tf32(net: nn.Module) -> None:
    """Mark every product of ``net``, the attention's included, to round
    its operands to TF32."""
    nets.use_tf32([net])
    for module in net.modules():
        if isinstance(module, Attention):
            module.tf32 = True


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    if not tf32:
        return a @ b
    return nets._RoundGrad.apply(nets._tf32(a) @ nets._tf32(b))


def drop_path(x: torch.Tensor, p: float, generator) -> torch.Tensor:
    """Per-sample stochastic depth: one keep draw a row of ``x``."""
    if p == 0.0:
        return x
    keep = torch.empty((x.shape[0],) + (1,) * (x.ndim - 1), device=x.device).bernoulli_(
        1.0 - p, generator=generator)
    return x * keep / (1.0 - p)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        d = C // self.heads
        tf32 = getattr(self, "tf32", False)
        q, k, v = nets.linear(x, self.qkv).reshape(B, N, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(matmul(q, k.transpose(-2, -1), tf32) * d ** -0.5, dim=-1)
        return nets.linear(matmul(attn, v, tf32).transpose(1, 2).reshape(B, N, C), self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return nets.linear(F.gelu(nets.linear(x, self.fc1)), self.fc2)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, drop_path: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = drop_path

    def forward(self, x, generator):
        rate = self.drop_path if self.training else 0.0
        x = x + drop_path(self.attn(self.norm1(x)), rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), rate, generator)


class PoseFormer(nn.Module):
    """Clips (B, F, J, 2) -> the centre frame (B, 1, J, 3)."""

    def __init__(self, frames: int, joints: int = 16, embed_dim_ratio: int = 32,
                 depth: int = 4, num_heads: int = 8, mlp_ratio: float = 2.0,
                 drop_path_rate: float = 0.1):
        super().__init__()
        C, J = embed_dim_ratio, joints
        E = C * J
        self.frames, self.joints = frames, joints
        rates = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.Spatial_patch_to_embedding = nn.Linear(2, C)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, J, C))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, frames, E))
        self.Spatial_blocks = nn.ModuleList(Block(C, num_heads, mlp_ratio, r) for r in rates)
        self.blocks = nn.ModuleList(Block(E, num_heads, mlp_ratio, r) for r in rates)
        self.Spatial_norm = nn.LayerNorm(C, eps=1e-6)
        self.Temporal_norm = nn.LayerNorm(E, eps=1e-6)
        self.weighted_mean = nn.Conv1d(frames, 1, 1)
        self.head = nn.Sequential(nn.LayerNorm(E, eps=1e-5), nn.Linear(E, J * 3))

    def forward(self, x, generator=None):
        Fr, J = self.frames, self.joints
        B = x.shape[0]
        h = nets.linear(x.reshape(B * Fr, J, 2), self.Spatial_patch_to_embedding) \
            + self.Spatial_pos_embed
        for block in self.Spatial_blocks:
            h = block(h, generator)
        h = self.Spatial_norm(h).reshape(B, Fr, J * h.shape[-1]) + self.Temporal_pos_embed
        for block in self.blocks:
            h = block(h, generator)
        h = nets.conv1d(self.Temporal_norm(h), self.weighted_mean)      # (B, 1, E)
        return nets.linear(self.head[0](h), self.head[1]).reshape(B, 1, J, 3)
