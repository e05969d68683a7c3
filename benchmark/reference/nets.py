"""Plain PyTorch nets of DH-AUG for the benchmark's reference: the FK-GAN
generator trunk, the single-frame 3D and 2D critics, the two motion
critics and VideoPose's strided temporal net.

Parameter names and shapes are the published models' ``state_dict`` keys,
so one state dict made by :func:`init_weights` loads into these nets and
into the program's.  Every dense and convolution product goes through
:func:`linear` / :func:`conv1d`: plain float32 (the caller keeps TF32
off), or, in a net that :func:`use_tf32` marked, every GEMM operand
rounded to TF32's 10-bit mantissa, in the forward pass and in each
backward product, which is what a TF32 tensor core does with float32
inputs.  The latter is the correctness control of the float32 training
cell.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.geometry import kcs_features

def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``t`` rounded to nearest (ties away) at ``bits`` mantissa bits."""
    drop = 23 - bits
    i = t.contiguous().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32).view_as(t)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; rounds the gradient that reaches a product's
    output to TF32, so the backward products see TF32 operands too.
    Differentiable again, for the penalty's double backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    # straight-through rounding: the value is rounded, the derivative is 1
    return t + (round_mantissa(t.detach(), 10) - t.detach())


def use_tf32(nets) -> None:
    """Mark every dense and convolution layer of ``nets`` to round its
    product operands to TF32."""
    for net in nets:
        for module in net.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d)):
                module.tf32 = True


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    if not getattr(layer, "tf32", False):
        return F.linear(x, layer.weight, layer.bias)
    return _RoundGrad.apply(F.linear(_tf32(x), _tf32(layer.weight), layer.bias))


def conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    args = conv.bias, conv.stride, conv.padding, conv.dilation
    if not getattr(conv, "tf32", False):
        return F.conv1d(x, conv.weight, *args)
    return _RoundGrad.apply(F.conv1d(_tf32(x), _tf32(conv.weight), *args))


class DenseResBlock(nn.Module):
    """relu(W2 relu(W1 x) + x)."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, x):
        return F.relu(linear(F.relu(linear(x, self.fc1)), self.fc2) + x)


class DensePrelude(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, dim)

    def forward(self, x):
        return F.relu(linear(x, self.fc))


class ResTower(nn.Module):
    def __init__(self, in_dim: int, dim: int, blocks: int = 3):
        super().__init__()
        self.prelude = DensePrelude(in_dim, dim)
        self.blocks = nn.ModuleList(DenseResBlock(dim) for _ in range(blocks))

    def forward(self, x):
        x = self.prelude(x)
        for block in self.blocks:
            x = block(x)
        return x


class Generator(nn.Module):
    """noise (B, noise) -> head (B, frames x 35): prelude, 3 residual
    blocks, head."""

    def __init__(self, dense: int, noise: int = 128, head: int = 35):
        super().__init__()
        self.prelude = DensePrelude(noise, dense)
        self.blocks = nn.ModuleList(DenseResBlock(dense) for _ in range(3))
        self.head = nn.Linear(dense, head)

    def forward(self, noise):
        x = self.prelude(noise)
        for block in self.blocks:
            x = block(x)
        return linear(x, self.head)


class Critic3D(nn.Module):
    """KCS(30) tower || pose(48) tower -> merge(100) -> residual block -> 1."""

    def __init__(self, dense: int):
        super().__init__()
        self.kcs_tower = ResTower(30, dense)
        self.pose_tower = ResTower(48, dense)
        self.merge = DensePrelude(2 * dense, 100)
        self.merge_block = DenseResBlock(100)
        self.out = nn.Linear(100, 1)

    def forward(self, pose3d):
        pose3d = pose3d.reshape(-1, 16, 3)
        merged = torch.cat([self.kcs_tower(kcs_features(pose3d)),
                            self.pose_tower(pose3d.reshape(-1, 48))], dim=-1)
        return linear(self.merge_block(self.merge(merged)), self.out)


class Critic2D(nn.Module):
    """LeakyReLU MLP on (B, 16, 2): d3 = lrelu(l3(d2) + d1), d4 linear."""

    def __init__(self, dense: int):
        super().__init__()
        self.fc1 = nn.Linear(32, dense)
        self.fc2 = nn.Linear(dense, dense)
        self.fc3 = nn.Linear(dense, dense)
        self.fc4 = nn.Linear(dense, dense)
        self.fc5 = nn.Linear(dense, dense)
        self.out = nn.Linear(dense, 1)

    def forward(self, pose2d):
        x = pose2d.reshape(-1, 32)
        d1 = F.leaky_relu(linear(x, self.fc1))
        d2 = F.leaky_relu(linear(d1, self.fc2))
        d3 = F.leaky_relu(linear(d2, self.fc3) + d1)
        d4 = linear(d3, self.fc4)
        return linear(F.leaky_relu(linear(d4, self.fc5)), self.out)


def temporal_diff(x):
    return x[:, 1:] - x[:, :-1]


class MotionCritic3D(nn.Module):
    """Clips (B, F, 16, 3): KCS, diff-KCS, pose and diff-pose towers."""

    def __init__(self, frames: int, dense: int):
        super().__init__()
        self.frames = frames
        self.kcs_tower = ResTower(frames * 15, dense)
        self.kcs_diff_tower = ResTower((frames - 1) * 15, dense)
        self.pose_tower = ResTower(frames * 48, dense)
        self.pose_diff_tower = ResTower((frames - 1) * 48, dense)
        self.merge = DensePrelude(4 * dense, 100)
        self.merge_block = DenseResBlock(100)
        self.out = nn.Linear(100, 1)

    def forward(self, clip3d):
        F_ = self.frames
        clip3d = clip3d.reshape(-1, F_, 16, 3)
        B = clip3d.shape[0]
        kcs = kcs_features(clip3d, with_lengths=False)
        branches = [self.kcs_tower(kcs.reshape(B, F_ * 15)),
                    self.kcs_diff_tower(temporal_diff(kcs).reshape(B, (F_ - 1) * 15)),
                    self.pose_tower(clip3d.reshape(B, F_ * 48)),
                    self.pose_diff_tower(temporal_diff(clip3d.reshape(B, F_, 48))
                                         .reshape(B, (F_ - 1) * 48))]
        return linear(self.merge_block(self.merge(torch.cat(branches, dim=-1))), self.out)


class MotionCritic2D(nn.Module):
    """Clips (B, F, 16, 2): a pose tower and a root-step tower."""

    def __init__(self, frames: int, dense: int):
        super().__init__()
        self.frames = frames
        self.pose_tower = ResTower(frames * 32, dense)
        self.root_diff_tower = ResTower((frames - 1) * 2, dense)
        self.merge = DensePrelude(2 * dense, 100)
        self.merge_block = DenseResBlock(100)
        self.out = nn.Linear(100, 1)

    def forward(self, clip2d):
        F_ = self.frames
        clip2d = clip2d.reshape(-1, F_, 16, 2)
        B = clip2d.shape[0]
        root_diff = temporal_diff(clip2d[:, :, 0, :]).reshape(B, (F_ - 1) * 2)
        merged = torch.cat([self.pose_tower(clip2d.reshape(B, F_ * 32)),
                            self.root_diff_tower(root_diff)], dim=-1)
        return linear(self.merge_block(self.merge(merged)), self.out)


def dropout(x, p: float, generator):
    """Inverted dropout whose mask is one Bernoulli draw of ``x``'s layout."""
    if p == 0.0:
        return x
    return x * torch.empty_like(x).bernoulli_(1.0 - p, generator=generator) / (1.0 - p)


def batch_norm(dim: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(dim, eps=1e-5, momentum=0.1)


class VideoPoseNet(nn.Module):
    """VideoPose3D's strided training net: clips (B, T, 16, 2) -> the
    centre frame (B, 1, 16, 3)."""

    def __init__(self, widths: Sequence[int], channels: int, p: float):
        super().__init__()
        self.widths = tuple(widths)
        w0 = self.widths[0]
        self.expand_conv = nn.Conv1d(32, channels, w0, stride=w0, bias=False)
        self.expand_bn = batch_norm(channels)
        convs, bns = [], []
        for w in self.widths[1:]:
            convs.append(nn.Conv1d(channels, channels, w, stride=w, bias=False))
            convs.append(nn.Conv1d(channels, channels, 1, bias=False))
            bns += [batch_norm(channels), batch_norm(channels)]
        self.layers_conv = nn.ModuleList(convs)
        self.layers_bn = nn.ModuleList(bns)
        self.shrink = nn.Conv1d(channels, 16 * 3, 1)
        self.p = p

    def forward(self, x, generator):
        B = x.shape[0]
        x = x.reshape(B, x.shape[1], 32).transpose(1, 2)
        x = dropout(F.relu(self.expand_bn(conv1d(x, self.expand_conv))), self.p, generator)
        for i, w in enumerate(self.widths[1:]):
            res = x[:, :, w // 2::w]
            y = dropout(F.relu(self.layers_bn[2 * i](conv1d(x, self.layers_conv[2 * i]))),
                        self.p, generator)
            y = dropout(F.relu(self.layers_bn[2 * i + 1](conv1d(y, self.layers_conv[2 * i + 1]))),
                        self.p, generator)
            x = res + y
        x = conv1d(x, self.shrink)
        return x.transpose(1, 2).reshape(B, -1, 16, 3)


_TRUNC = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


@torch.no_grad()
def init_weights(nets: Sequence[nn.Module], generator: torch.Generator) -> list:
    """Seeded weights for ``nets`` in place and as state dicts: every weight
    of two or more axes from one normal draw, clipped at two standard
    deviations and scaled to He's fan-in variance (what the published nets
    use); biases zero, batch-norm scales one and shifts zero.  One draw for
    all nets, on ``generator``'s device."""
    weights = [p for net in nets for name, p in net.named_parameters() if p.ndim >= 2]
    flat = torch.randn(sum(p.numel() for p in weights), generator=generator,
                       device=generator.device).clamp_(-2.0, 2.0)
    at = 0
    for p in weights:
        fan_in = p[0].numel()
        p.copy_(flat[at:at + p.numel()].view_as(p) * (math.sqrt(2.0 / fan_in) / _TRUNC))
        at += p.numel()
    for net in nets:
        for module in net.modules():
            if isinstance(module, nn.BatchNorm1d):
                module.reset_parameters()
            elif isinstance(module, (nn.Linear, nn.Conv1d)) and module.bias is not None:
                module.bias.zero_()
    return [net.state_dict() for net in nets]
