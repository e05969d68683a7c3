"""Optimizer constructors, gradient clipping and learning-rate schedules.

Port of ``dhaug_tpu/train/state.py``.  Each net keeps its own
``torch.optim`` optimizer; a learning-rate change rewrites the optimizer's
param groups.

Gradient clipping follows optax's ``clip_by_global_norm`` formula, which the
JAX package trains with: gradients are scaled by ``max_norm / norm`` when
``norm >= max_norm`` and left alone otherwise.  ``torch.nn.utils.
clip_grad_norm_`` differs slightly (it divides by ``norm + 1e-6`` and
rescales whenever that ratio is below 1), so :func:`clip_by_global_norm` is
used to keep the two packages' updates the same.
"""
from __future__ import annotations

from typing import Iterable

import torch


def adam_gan(params: Iterable[torch.nn.Parameter], lr: float = 1e-4) -> torch.optim.Adam:
    """GAN Adam: betas (0.5, 0.9) (model_fk_gan_train.py:112-118)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.9), eps=1e-8)


def adam_posenet(params: Iterable[torch.nn.Parameter], lr: float = 1e-4) -> torch.optim.Adam:
    """Posenet Adam (optax defaults: betas (0.9, 0.999), eps 1e-8); clip the
    gradients with :func:`clip_by_global_norm` before each step."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the ``.grad`` of ``params``, in place and
    without a host sync.  Returns the global norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def lambda_lr(base_lr: float, epoch: int, nepoch: int, nepoch_fix: int = 0) -> float:
    """The reference's LambdaLR linear decay (utils/utils.py:174-178):
    lr = base * (1 - max(0, epoch - fix) / (nepoch - fix + 1))."""
    return base_lr * (1.0 - max(0, epoch - nepoch_fix) / float(nepoch - nepoch_fix + 1))


def step_exp_lr(base_lr: float, step: int, decay_step: int, gamma: float) -> float:
    """The baseline runner's exponential decay (utils/utils.py:115-119):
    lr = base * gamma ** (step / decay_step)."""
    return base_lr * gamma ** (step / decay_step)


def step_lr(base_lr: float, epoch: int, decay_step: int, gamma: float = 0.1) -> float:
    """StepLR (utils/utils.py:179-181): lr = base * gamma ** (epoch // decay_step)."""
    return base_lr * gamma ** (epoch // decay_step)
