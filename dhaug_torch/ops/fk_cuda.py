"""CUDA kernels B1 (forward DH-FK) and B2 (its VJP): build, bind, launch.

The kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/fk_kernels.cu``,
per-pose math in ``csrc/fk_chain.cuh``).  They replace the Pallas kernels
``dhaug_tpu/ops/fk_pallas.py::_fk_kernel`` and ``::_fk_bwd_kernel``.

Build: at first use ``nvcc`` compiles the sources in this checkout into a
shared library with a plain C interface under ``dhaug_torch/_build/<hash>/``
(the hash covers the sources and flags), and ``ctypes`` loads it.  Nothing is
built at import time.

Routing: :func:`fk_world_pose_16` takes the plain PyTorch FK (``ops/fk.py``)
for CPU tensors only.  For CUDA tensors it launches the kernels or raises;
there is no fallback.  Under autograd the pair runs as :class:`FkFunction`
(forward = B1, backward = B2).

``FWD_LAUNCHES`` / ``BWD_LAUNCHES`` count kernel launches, one per launch and
nowhere else, so a run can show that its FK went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from dhaug_torch.ops import fk as fk_plain

FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("fk_kernels.cu", "fk_chain.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
# filled by build(): library path, seconds spent in nvcc (0.0 when the
# library was already built), and ptxas' register/spill report
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the FK kernels need the CUDA toolkit")
    return found


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libdhfk.so"
    report = out_dir / "ptxas.txt"
    seconds = 0.0
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libdhfk.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "fk_kernels.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    BUILD_INFO.update(library=str(lib), seconds=seconds,
                      ptxas=report.read_text() if report.exists() else "")
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dhfk_forward.argtypes = [vp, vp, vp, vp, vp, ci, vp]
        lib.dhfk_forward.restype = ci
        lib.dhfk_backward.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, vp]
        lib.dhfk_backward.restype = ci
        lib.dhfk_error_string.argtypes = [ci]
        lib.dhfk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.dhfk_error_string(rc).decode()}")


def fk_forward_cuda(angles, bone_len, global_rot, root) -> torch.Tensor:
    """B1: (B, 33), (B, 15), (B, 3), (B, 3) float32 CUDA -> (B, 16, 3)."""
    global FWD_LAUNCHES
    device = angles.device
    if device.type != "cuda":
        raise ValueError(f"fk_forward_cuda needs CUDA tensors, got {device}")
    B = angles.shape[0]
    for name, t, n in (("angles", angles, 33), ("bone_len", bone_len, 15),
                       ("global_rot", global_rot, 3), ("root", root, 3)):
        _check(name, t, (B, n), device)
    out = torch.empty((B, 16, 3), dtype=torch.float32, device=device)
    if B == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dhfk_forward(angles.data_ptr(), bone_len.data_ptr(),
                              global_rot.data_ptr(), root.data_ptr(),
                              out.data_ptr(), B, stream)
    _raise_on(lib, rc, "fk_forward_kernel")
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
        _check(name, t, shape, device)
    outs = [torch.empty((B, n), dtype=torch.float32, device=device)
            for n in (33, 15, 3, 3)]
    if B == 0:
        return tuple(outs)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dhfk_backward(angles.data_ptr(), bone_len.data_ptr(),
                               global_rot.data_ptr(), g.data_ptr(),
                               *[o.data_ptr() for o in outs], B, stream)
    _raise_on(lib, rc, "fk_backward_kernel")
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
