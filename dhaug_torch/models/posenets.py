"""The posenet zoo: port of ``dhaug_tpu/models/posenets.py``.

* :class:`LinearModel` -- the Martinez MLP (``mlp``);
* :class:`SemGCN` -- semantic graph convolutions over the 16 joints (``gcn``);
* :class:`TemporalPoseNet` -- VideoPose3D's temporal convolutions, the
  single-frame ``videopose`` head (widths all 1) and the multi-frame twins:
  ``strided=True`` is the training net, ``strided=False`` the dilated
  evaluation net, with one parameter set between them;
* :class:`PoseFormer` -- a spatial transformer per frame, a temporal one
  over frames and a weighted mean of the frames, each transformer in a
  span (``posenet.spatial``, ``posenet.temporal``; ``utils/profiling``).

Parameter names are the reference's ``state_dict`` keys (the names
``dhaug_tpu/utils/transplant.py`` reads), so a reference ``.pth.tar`` and a
port ``state_dict`` load alike with one strict ``load_state_dict``.

``nn.BatchNorm1d`` with momentum 0.1 and eps 1e-5 has the semantics the JAX
package wrote by hand: it normalizes with the biased batch variance and
updates the running variance with the unbiased one.  The temporal net and
SemGCN pool its statistics over batch and frames, or batch and joints.
Under data parallelism (``parallel/mesh.py``) it averages over the global
batch in train mode, as flax's ``BatchNorm`` does under a GSPMD mesh
(:class:`BatchNorm1d`).

Every ``forward`` takes ``(x, generator=None)``: dropout and drop-path draw
from that explicit ``torch.Generator`` (on the tensors' device), so a run is
reproducible from its seed; without one they fall back to torch's default
generator.  A rank of a data-parallel group draws each mask at the global
batch shape and keeps its own rows, so N ranks draw what one device draws.
Under tensor parallelism the wide layers are column-parallel
(``parallel/tensor.py``) and their outputs whole, so the ranks of a model
group draw the same masks and batch norm sees every channel; both read
the data axis only.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from dhaug_torch.models.blocks import dense, he_normal_, lecun_normal_
from dhaug_torch.parallel import mesh
from dhaug_torch.utils.profiling import span


def _empty_like_global(x: torch.Tensor, world: int) -> torch.Tensor:
    """An uninitialised tensor of ``x``'s layout with ``world`` times its
    leading axis: the mask one device would draw for the global batch."""
    if world == 1:
        return torch.empty_like(x)
    order = sorted(range(x.ndim), key=lambda d: -x.stride(d))   # outermost first
    shape = [x.shape[0] * world if d == 0 else x.shape[d] for d in order]
    return x.new_empty(shape).permute([order.index(d) for d in range(x.ndim)])


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    if not training or p == 0.0:
        return x
    dp = mesh.current()
    keep = dp.rows(_empty_like_global(x, dp.world).bernoulli_(1.0 - p, generator=generator))
    return x * keep / (1.0 - p)


def drop_path(x: torch.Tensor, p: float, training: bool,
              generator: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth: drop a sample's whole residual branch."""
    if not training or p == 0.0:
        return x
    dp = mesh.current()
    keep = x.new_empty((x.shape[0] * dp.world,) + (1,) * (x.ndim - 1)).bernoulli_(
        1.0 - p, generator=generator)
    return x * dp.rows(keep) / (1.0 - p)


class BatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (same parameters, buffers and ``state_dict``
    names) whose train-mode statistics cover the global batch of a
    data-parallel group: the per-channel sum, then the sum of squared
    deviations from the global mean, each summed over the ranks through an
    autograd-aware all-reduce.  A single device runs ``nn.BatchNorm1d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dp = mesh.current()
        if not (self.training and dp.sharded):
            return super().forward(x)
        dims = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        n = x.numel() // x.shape[1] * dp.world
        mean = mesh.sum_across(x.sum(dims)) / n
        xc = x - mean.reshape(shape)
        var = mesh.sum_across((xc * xc).sum(dims)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var * (n / (n - 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        y = xc * torch.rsqrt(var + self.eps).reshape(shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def batch_norm(dim: int) -> BatchNorm1d:
    return BatchNorm1d(dim, eps=1e-5, momentum=0.1)


def pad_hip(out15: torch.Tensor) -> torch.Tensor:
    """(B, 45) 15-joint prediction -> (B, 16, 3) with a zero hip at joint 0."""
    B = out15.shape[0]
    return torch.cat([out15.new_zeros(B, 3), out15], dim=1).reshape(B, 16, 3)


# ---------------------------------------------------------------------------
# Martinez-style MLP
# ---------------------------------------------------------------------------

class _LinearStage(nn.Module):
    def __init__(self, dim: int, p_dropout: float):
        super().__init__()
        self.w1 = dense(dim, dim)
        self.batch_norm1 = batch_norm(dim)
        self.w2 = dense(dim, dim)
        self.batch_norm2 = batch_norm(dim)
        self.p_dropout = p_dropout

    def forward(self, x, generator=None):
        p, train = self.p_dropout, self.training
        y = dropout(F.relu(self.batch_norm1(self.w1(x))), p, train, generator)
        y = dropout(F.relu(self.batch_norm2(self.w2(y))), p, train, generator)
        return x + y


class LinearModel(nn.Module):
    """16x2 -> linear_size -> num_stage residual stages -> 15x3, hip padded."""

    def __init__(self, linear_size: int = 1024, num_stage: int = 2,
                 p_dropout: float = 0.5):
        super().__init__()
        self.w1 = dense(32, linear_size)
        self.batch_norm1 = batch_norm(linear_size)
        self.linear_stages = nn.ModuleList(_LinearStage(linear_size, p_dropout)
                                           for _ in range(num_stage))
        self.w2 = dense(linear_size, 45)
        self.p_dropout = p_dropout

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        x = x.reshape(x.shape[0], 32)
        y = dropout(F.relu(self.batch_norm1(self.w1(x))), self.p_dropout, self.training,
                    generator)
        for stage in self.linear_stages:
            y = stage(y, generator)
        return pad_hip(self.w2(y))


# ---------------------------------------------------------------------------
# SemGCN
# ---------------------------------------------------------------------------

class SemGraphConv(nn.Module):
    """Learned per-edge weights ``e`` softmaxed over the adjacency's support
    (entries off the support are -9e15 and come out as exact zeros), with
    separate self and neighbour projections ``W[0]``/``W[1]``."""

    def __init__(self, in_features: int, out_features: int, adj: np.ndarray):
        super().__init__()
        mask = np.asarray(adj) > 0
        self.W = nn.Parameter(torch.empty(2, in_features, out_features))
        self.e = nn.Parameter(torch.ones(1, int(mask.sum())))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.register_buffer("mask", torch.as_tensor(mask), persistent=False)
        # flax xavier-uniform, gain 1.414, on the (2, in, out) kernel: flax
        # counts fan_in = 2 * in and fan_out = 2 * out
        bound = 1.414 * math.sqrt(6.0 / (2 * in_features + 2 * out_features))
        nn.init.uniform_(self.W, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x @ self.W[0]
        h1 = x @ self.W[1]
        J = self.mask.shape[0]
        logits = self.e.new_full((J, J), -9e15).masked_scatter(self.mask, self.e.reshape(-1))
        attn = torch.softmax(logits, dim=1)
        eye = torch.eye(J, dtype=x.dtype, device=x.device)
        # self term: the diagonal scales h0; neighbour term: one (J, J) x
        # (J, B*D) product rather than B small ones
        return (torch.diagonal(attn)[:, None] * h0
                + torch.einsum("ij,...jd->...id", attn * (1 - eye), h1) + self.bias)


class _GraphConv(nn.Module):
    """SemGraphConv -> BatchNorm over channels (pooled over batch and
    joints) -> [dropout(relu)] -> relu."""

    def __init__(self, adj: np.ndarray, in_dim: int, out_dim: int, p_dropout: float):
        super().__init__()
        self.gconv = SemGraphConv(in_dim, out_dim, adj)
        self.bn = batch_norm(out_dim)
        self.p_dropout = p_dropout

    def forward(self, x, generator=None):
        x = self.bn(self.gconv(x).transpose(1, 2)).transpose(1, 2)
        if self.p_dropout:
            x = dropout(F.relu(x), self.p_dropout, self.training, generator)
        return F.relu(x)


class _ResGraphConv(nn.Module):
    def __init__(self, adj: np.ndarray, dim: int, p_dropout: float):
        super().__init__()
        self.gconv1 = _GraphConv(adj, dim, dim, p_dropout)
        self.gconv2 = _GraphConv(adj, dim, dim, p_dropout)

    def forward(self, x, generator=None):
        return x + self.gconv2(self.gconv1(x, generator), generator)


class SemGCN(nn.Module):
    """(B, 16, 2) -> (B, 16, 3): an input graph conv, ``num_layers``
    residual pairs, and an output SemGraphConv."""

    def __init__(self, adj: np.ndarray, hid_dim: int = 128, num_layers: int = 4,
                 p_dropout: float = 0.25):
        super().__init__()
        self.gconv_input = nn.ModuleList([_GraphConv(adj, 2, hid_dim, p_dropout)])
        self.gconv_layers = nn.ModuleList(_ResGraphConv(adj, hid_dim, p_dropout)
                                          for _ in range(num_layers))
        self.gconv_output = SemGraphConv(hid_dim, 3, adj)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        out = self.gconv_input[0](x.reshape(x.shape[0], 16, 2), generator)
        for layer in self.gconv_layers:
            out = layer(out, generator)
        return self.gconv_output(out)


# ---------------------------------------------------------------------------
# VideoPose3D temporal convolutions
# ---------------------------------------------------------------------------

class TemporalPoseNet(nn.Module):
    """Temporal convolutions over (B, T, 16, 2) (or (B, 16, 2) / (B, 32) for
    one frame), in the (B, C, T) layout of ``Conv1d``.

    ``strided=True`` convolves with stride == width, collapsing the
    receptive field to one output frame; ``strided=False`` dilates instead
    and keeps every valid frame.  ``out_joints=15, pad_hip_joint=True`` is
    the single-frame ``videopose`` head, returning (B, 16, 3); otherwise the
    output is (B, T_out, out_joints, 3)."""

    def __init__(self, filter_widths: Sequence[int], out_joints: int = 16,
                 pad_hip_joint: bool = False, channels: int = 1024,
                 p_dropout: float = 0.25, strided: bool = True):
        super().__init__()
        self.filter_widths = tuple(int(w) for w in filter_widths)
        self.out_joints = out_joints
        self.pad_hip_joint = pad_hip_joint
        self.p_dropout = p_dropout
        self.strided = strided
        w0 = self.filter_widths[0]
        self.expand_conv = nn.Conv1d(32, channels, w0, stride=w0 if strided else 1,
                                     bias=False)
        self.expand_bn = batch_norm(channels)
        convs, bns, self.res_pads = [], [], []
        dilation = w0
        for w in self.filter_widths[1:]:
            convs.append(nn.Conv1d(channels, channels, w, stride=w if strided else 1,
                                   dilation=1 if strided else dilation, bias=False))
            convs.append(nn.Conv1d(channels, channels, 1, bias=False))
            bns += [batch_norm(channels), batch_norm(channels)]
            self.res_pads.append((w - 1) * dilation // 2)
            dilation *= w
        self.layers_conv = nn.ModuleList(convs)
        self.layers_bn = nn.ModuleList(bns)
        self.shrink = nn.Conv1d(channels, out_joints * 3, 1)
        for conv in [self.expand_conv, *convs, self.shrink]:
            he_normal_(conv.weight)
        nn.init.zeros_(self.shrink.bias)

    def receptive_field(self) -> int:
        return math.prod(self.filter_widths)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        B = x.shape[0]
        if x.ndim == 2:
            x = x.reshape(B, 1, 16, 2)
        elif x.ndim == 3:
            x = x[:, None]
        x = x.reshape(B, x.shape[1], 32).transpose(1, 2)          # (B, 32, T)
        p, train = self.p_dropout, self.training
        x = dropout(F.relu(self.expand_bn(self.expand_conv(x))), p, train, generator)
        for i, w in enumerate(self.filter_widths[1:]):
            if self.strided:
                res = x[:, :, w // 2::w]
            else:
                pad = self.res_pads[i]
                res = x[:, :, pad:x.shape[2] - pad]
            y = dropout(F.relu(self.layers_bn[2 * i](self.layers_conv[2 * i](x))),
                        p, train, generator)
            y = dropout(F.relu(self.layers_bn[2 * i + 1](self.layers_conv[2 * i + 1](y))),
                        p, train, generator)
            x = res + y
        x = self.shrink(x)                                          # (B, J*3, T_out)
        if self.pad_hip_joint:
            return pad_hip(x.reshape(B, self.out_joints * 3))
        return x.transpose(1, 2).reshape(B, -1, self.out_joints, 3)


# ---------------------------------------------------------------------------
# PoseFormer
# ---------------------------------------------------------------------------

def _linear(in_dim: int, out_dim: int) -> nn.Linear:
    """flax's default ``Dense``: lecun-normal kernel, zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    lecun_normal_(layer.weight)
    nn.init.zeros_(layer.bias)
    return layer


class Attention(nn.Module):
    """softmax(Q K^T / sqrt(head_dim)) V from one ``qkv`` projection, heads
    concatenated into ``proj``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                        # (B, H, N, hd) each
        attn = torch.softmax((q @ k.transpose(-2, -1)) * self.scale, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = _linear(dim, hidden)
        self.fc2 = _linear(hidden, dim)


class Block(nn.Module):
    """Pre-norm transformer block: attention and an exact-GELU MLP, each a
    residual branch with stochastic depth; LayerNorm eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, drop_path: float,
                 p_dropout: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = drop_path
        self.p_dropout = p_dropout

    def forward(self, x, generator=None):
        train = self.training
        x = x + drop_path(self.attn(self.norm1(x)), self.drop_path, train, generator)
        h = F.gelu(self.mlp.fc1(self.norm2(x)))
        h = dropout(h, self.p_dropout, train, generator)
        h = dropout(self.mlp.fc2(h), self.p_dropout, train, generator)
        return x + drop_path(h, self.drop_path, train, generator)


class PoseFormer(nn.Module):
    """(B, F, J, 2) -> centre-frame 3D pose (B, 1, J, 3)."""

    def __init__(self, num_frame: int = 9, num_joints: int = 16, embed_dim_ratio: int = 32,
                 depth: int = 4, num_heads: int = 8, mlp_ratio: float = 2.0,
                 drop_path_rate: float = 0.1, p_dropout: float = 0.0):
        super().__init__()
        C, J = embed_dim_ratio, num_joints
        E = C * J
        self.num_frame, self.num_joints, self.p_dropout = num_frame, num_joints, p_dropout
        self.Spatial_patch_to_embedding = _linear(2, C)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, J, C))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, num_frame, E))
        dpr = np.linspace(0, drop_path_rate, depth)
        self.Spatial_blocks = nn.ModuleList(
            Block(C, num_heads, mlp_ratio, float(dpr[i]), p_dropout) for i in range(depth))
        self.blocks = nn.ModuleList(
            Block(E, num_heads, mlp_ratio, float(dpr[i]), p_dropout) for i in range(depth))
        self.Spatial_norm = nn.LayerNorm(C, eps=1e-6)
        self.Temporal_norm = nn.LayerNorm(E, eps=1e-6)
        # the weighted mean over frames: Conv1d(F, 1, 1), lecun-normal over F
        self.weighted_mean = nn.Conv1d(num_frame, 1, 1)
        lecun_normal_(self.weighted_mean.weight)
        nn.init.zeros_(self.weighted_mean.bias)
        # the head's LayerNorm has torch's default eps 1e-5, not the blocks'
        self.head = nn.Sequential(nn.LayerNorm(E, eps=1e-5), _linear(E, J * 3))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        Fr, J = self.num_frame, self.num_joints
        x = x.reshape(-1, Fr, J, 2)
        B = x.shape[0]
        with span("posenet.spatial"):
            h = self.Spatial_patch_to_embedding(x.reshape(B * Fr, J, 2)) + self.Spatial_pos_embed
            h = dropout(h, self.p_dropout, self.training, generator)
            for block in self.Spatial_blocks:
                h = block(h, generator)
            h = self.Spatial_norm(h).reshape(B, Fr, -1)
        with span("posenet.temporal"):
            h = dropout(h + self.Temporal_pos_embed, self.p_dropout, self.training, generator)
            for block in self.blocks:
                h = block(h, generator)
            h = self.weighted_mean(self.Temporal_norm(h))           # (B, 1, E)
            return self.head(h).reshape(B, 1, J, 3)
