"""The CUDA kernels' per-pose math (dhaug_torch/csrc/fk_chain.cuh), built
for the host with g++, against the plain FK and its autograd gradients.

This is the check of the kernels' arithmetic that needs no card: the same
``fk_pose_forward`` / ``fk_pose_backward`` functions the kernels call, with
``__host__``/``__device__`` defined empty.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dhaug_torch.ops import fk as t_fk
from dhaug_torch.ops.fk_cuda import CSRC

_HOST_LOOP = r"""
#include "fk_chain.cuh"
extern "C" void fk_forward_host(const float* a, const float* b, const float* g,
                                const float* r, float* out, int B) {
  for (int i = 0; i < B; ++i)
    dhfk::fk_pose_forward(a + 33 * i, b + 15 * i, g + 3 * i, r + 3 * i, out + 48 * i);
}
extern "C" void fk_backward_host(const float* a, const float* b, const float* gr,
                                 const float* g, float* da, float* db, float* dg,
                                 float* dr, int B) {
  for (int i = 0; i < B; ++i)
    dhfk::fk_pose_backward(a + 33 * i, b + 15 * i, gr + 3 * i, g + 48 * i,
                           da + 33 * i, db + 15 * i, dg + 3 * i, dr + 3 * i);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel math needs it")
    build = tmp_path_factory.mktemp("fk_host")
    src = build / "fk_host.cpp"
    src.write_text(_HOST_LOOP)
    lib_path = build / "libfk_host.so"
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-D__host__=",
                    "-D__device__=", f"-I{CSRC}", str(src), "-o", str(lib_path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fk_forward_host.argtypes = [vp] * 5 + [ci]
    lib.fk_forward_host.restype = None
    lib.fk_backward_host.argtypes = [vp] * 8 + [ci]
    lib.fk_backward_host.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _inputs(seed, B):
    rng = np.random.default_rng(seed)
    return [np.ascontiguousarray(a, np.float32) for a in (
        rng.uniform(-120, 120, (B, 33)), rng.uniform(0.1, 0.7, (B, 15)),
        rng.uniform(-180, 180, (B, 3)), rng.normal(size=(B, 3)),
        rng.normal(size=(B, 16, 3)))]


@pytest.mark.parametrize("B", [1, 96, 513])
def test_forward_matches_plain_fk(host_lib, B):
    ang, bl, grot, root, _ = _inputs(B, B)
    out = np.zeros((B, 16, 3), np.float32)
    host_lib.fk_forward_host(_ptr(ang), _ptr(bl), _ptr(grot), _ptr(root), _ptr(out), B)
    ref = t_fk.fk_world_pose_16(*[torch.from_numpy(a) for a in (ang, bl, grot, root)])
    np.testing.assert_allclose(out, ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("B", [1, 64, 70])
def test_backward_matches_autograd(host_lib, B):
    ang, bl, grot, root, cot = _inputs(B + 100, B)
    outs = [np.zeros((B, n), np.float32) for n in (33, 15, 3, 3)]
    host_lib.fk_backward_host(_ptr(ang), _ptr(bl), _ptr(grot), _ptr(cot),
                              *[_ptr(o) for o in outs], B)
    t_in = [torch.tensor(a, requires_grad=True) for a in (ang, bl, grot, root)]
    ref = torch.autograd.grad(t_fk.fk_world_pose_16(*t_in), t_in, torch.from_numpy(cot))
    for name, r, g in zip(("dangles", "dbone_len", "dglobal_rot", "droot"), ref, outs):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_backward_bone_signs_on_mirrored_links(host_lib):
    """The a = -bone links (left hip, right shoulder) flip their gradient's
    sign: a one-hot cotangent on the joint they move must give a bone
    gradient of the sign autograd gives."""
    ang, bl, grot, root, _ = _inputs(5, 1)
    for slot in (4, 13):  # LHip, RShoulder
        cot = np.zeros((1, 16, 3), np.float32)
        cot[0, slot] = (1.0, -0.5, 0.25)
        outs = [np.zeros((1, n), np.float32) for n in (33, 15, 3, 3)]
        host_lib.fk_backward_host(_ptr(ang), _ptr(bl), _ptr(grot), _ptr(cot),
                                  *[_ptr(o) for o in outs], 1)
        t_in = [torch.tensor(a, requires_grad=True) for a in (ang, bl, grot, root)]
        (dbl,) = torch.autograd.grad(t_fk.fk_world_pose_16(*t_in), [t_in[1]],
                                     torch.from_numpy(cot))
        np.testing.assert_allclose(outs[1], dbl.numpy(), atol=1e-6, rtol=1e-5)
        assert np.abs(dbl.numpy()).max() > 0.1
