"""CUDA kernels B1 (forward DH-FK) and B2 (its VJP): build, bind, launch.

The kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/fk_kernels.cu``,
tile phases in ``csrc/fk_chain.cuh``: a block takes 32 poses and spreads
their trig, five chains and outputs across its threads).  They replace the
Pallas kernels ``dhaug_tpu/ops/fk_pallas.py::_fk_kernel`` and
``::_fk_bwd_kernel``.

Build: ``ops/cuda_lib.py`` compiles ``csrc/fk_kernels.cu`` with ``nvcc`` at
first use into a shared library with a plain C interface, and ``ctypes``
loads it.  Nothing is built at import time.

Routing: :func:`fk_world_pose_16` takes the plain PyTorch FK (``ops/fk.py``)
for CPU tensors only.  For CUDA tensors it launches the kernels or raises;
there is no fallback.  Under autograd the pair runs as :class:`FkFunction`
(forward = B1, backward = B2).

``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count kernel launches, one per launch and
nowhere else, so a run can show that its FK went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from dhaug_torch.ops import cuda_lib
from dhaug_torch.ops import fk as fk_plain

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

# fp32 adds and multiplies per pose, counted from csrc/fk_chain.cuh (sin/cos
# not counted): forward = 33 links x 8 (theta, Q, t) + 30 chain steps x 63
# (R t, p +=, R Q) + 27 (Euler) + 16 joints x 18 (Rg p + root); backward =
# the forward walk with the dRg/droot accumulation (~2.6 k) + the rotation
# recompute (~1.6 k) + 33 reverse steps of ~146 and the 16 joint cotangents.
FWD_FLOP_PER_POSE = 33 * 8 + 30 * 63 + 27 + 16 * 18
BWD_FLOP_PER_POSE = 2611 + 1614 + 33 * 146 + 16 * 18

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("fk_kernels")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dhfk_forward.argtypes = [vp, vp, vp, vp, vp, ci, vp]
        lib.dhfk_forward.restype = ci
        lib.dhfk_backward.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.dhfk_backward.restype = ci
        lib.dhfk_error_string.argtypes = [ci]
        lib.dhfk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fk_forward_cuda(angles, bone_len, global_rot, root) -> torch.Tensor:
    """B1: (B, 33), (B, 15), (B, 3), (B, 3) float32 CUDA -> (B, 16, 3)."""
    global FWD_LAUNCHES
    device = angles.device
    if device.type != "cuda":
        raise ValueError(f"fk_forward_cuda needs CUDA tensors, got {device}")
    B = angles.shape[0]
    for name, t, n in (("angles", angles, 33), ("bone_len", bone_len, 15),
                       ("global_rot", global_rot, 3), ("root", root, 3)):
        cuda_lib.check_tensor(name, t, (B, n), torch.float32, device)
    out = torch.empty((B, 16, 3), dtype=torch.float32, device=device)
    if B == 0:
        return out
    lib = _lib()
    rc = cuda_lib.launch_on(device, lambda stream: lib.dhfk_forward(
        angles.data_ptr(), bone_len.data_ptr(), global_rot.data_ptr(), root.data_ptr(),
        out.data_ptr(), B, stream))
    cuda_lib.raise_on(lib.dhfk_error_string, rc, "fk_forward_kernel")
    FWD_LAUNCHES += 1
    return out


def fk_backward_cuda(angles, bone_len, global_rot, g):
    """B2: the VJP of B1 for cotangent g (B, 16, 3) ->
    (dangles (B, 33), dbone_len (B, 15), dglobal_rot (B, 3), droot (B, 3))."""
    global BWD_LAUNCHES
    device = angles.device
    if device.type != "cuda":
        raise ValueError(f"fk_backward_cuda needs CUDA tensors, got {device}")
    B = angles.shape[0]
    for name, t, shape in (("angles", angles, (B, 33)), ("bone_len", bone_len, (B, 15)),
                           ("global_rot", global_rot, (B, 3)), ("g", g, (B, 16, 3))):
        cuda_lib.check_tensor(name, t, shape, torch.float32, device)
    outs = [torch.empty((B, n), dtype=torch.float32, device=device)
            for n in (33, 15, 3, 3)]
    if B == 0:
        return tuple(outs)
    lib = _lib()
    rc = cuda_lib.launch_on(device, lambda stream: lib.dhfk_backward(
        angles.data_ptr(), bone_len.data_ptr(), global_rot.data_ptr(), g.data_ptr(),
        *[o.data_ptr() for o in outs], B, stream))
    cuda_lib.raise_on(lib.dhfk_error_string, rc, "fk_backward_kernel")
    BWD_LAUNCHES += 1
    return tuple(outs)


class FkFunction(torch.autograd.Function):
    """Differentiable fused FK on the card: forward B1, backward B2 (the
    counterpart of ``fk_world_pose_pallas_vjp``).  First derivatives only:
    the generator loss needs one derivative through FK, and the critics'
    double backward never sees FK."""

    @staticmethod
    def forward(ctx, angles, bone_len, global_rot, root):
        ctx.save_for_backward(angles, bone_len, global_rot)
        return fk_forward_cuda(angles, bone_len, global_rot, root)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        angles, bone_len, global_rot = ctx.saved_tensors
        return fk_backward_cuda(angles, bone_len, global_rot, g.contiguous())


def fk_world_pose_16(angles, bone_len, global_rot, root) -> torch.Tensor:
    """16-joint world pose (B, 16, 3) from contiguous (B, 33), (B, 15),
    (B, 3), (B, 3) float32 tensors.  CPU tensors take the plain FK (autograd
    for the gradient); CUDA tensors take B1, or B1/B2 through
    :class:`FkFunction` when a gradient is needed."""
    if angles.device.type == "cpu":
        return fk_plain.fk_world_pose_16(angles, bone_len, global_rot, root)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (angles, bone_len, global_rot, root))
    if needs_grad:
        return FkFunction.apply(angles, bone_len, global_rot, root)
    return fk_forward_cuda(angles, bone_len, global_rot, root)
