"""dhaug_torch: the PyTorch/CUDA port of DH-AUG's single-frame FK-GAN training.

The package mirrors ``dhaug_tpu``'s module names (``ops.fk``, ``gan.wgan``,
``train.posenet``, ...) so each piece has an obvious counterpart, but imports
nothing from it: the JAX package is the reference the port is tested against.

Geometry stays in full fp32.  The JAX side pins ``Precision.HIGHEST`` on every
geometry contraction; the equivalent here is to keep TF32 off for both matmuls
and cuDNN, which :func:`set_fp32_precision` does when the package is imported.
"""
from __future__ import annotations

import torch


def set_fp32_precision() -> None:
    """Keep float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """``'cuda'`` or ``'cpu'`` -> torch.device.  Asking for CUDA on a machine
    without a card raises; nothing quietly drops to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available "
            "(pass --device cpu to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    return device


set_fp32_precision()
