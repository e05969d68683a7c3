"""The CUDA kernels' tile phases (dhaug_torch/csrc/fk_chain.cuh), built for
the host with g++, against the plain FK, its autograd gradients and the JAX
Pallas kernels in interpret mode.

This is the check of the kernels' arithmetic that needs no card: the host
drivers ``fk_forward_host`` / ``fk_backward_host`` run the same phase
functions the kernels call, in the kernels' order and tile by tile (one loop
per phase where a kernel has ``__syncthreads``), with ``__host__`` and
``__device__`` defined empty.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch.ops import fk as t_fk
from dhaug_torch.ops.cuda_lib import CSRC
from dhaug_tpu.ops.fk_pallas import fk_bwd_pallas, fk_world_pose_pallas

TILE = 32  # dhfk::kTile: poses a block

_HOST_LOOP = r"""
#include "fk_chain.cuh"
extern "C" void fk_forward_host(const float* a, const float* b, const float* g,
                                const float* r, float* out, int B) {
  dhfk::fk_forward_host(a, b, g, r, out, B);
}
extern "C" void fk_backward_host(const float* a, const float* b, const float* gr,
                                 const float* g, float* da, float* db, float* dg,
                                 float* dr, int B) {
  dhfk::fk_backward_host(a, b, gr, g, da, db, dg, dr, B);
}
extern "C" int fk_tile() { return dhfk::kTile; }
extern "C" void sincos_host(const float* x, float* s, float* c, int n) {
  for (int i = 0; i < n; ++i) dhfk::precise_sincos(x[i], s[i], c[i]);
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
    subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-fno-strict-aliasing",
                    "-D__host__=", "-D__device__=", f"-I{CSRC}", str(src), "-o",
                    str(lib_path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fk_forward_host.argtypes = [vp] * 5 + [ci]
    lib.fk_forward_host.restype = None
    lib.fk_backward_host.argtypes = [vp] * 8 + [ci]
    lib.fk_backward_host.restype = None
    lib.sincos_host.argtypes = [vp] * 3 + [ci]
    lib.sincos_host.restype = None
    assert lib.fk_tile() == TILE
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _inputs(seed, B):
    rng = np.random.default_rng(seed)
    return [np.ascontiguousarray(a, np.float32) for a in (
        rng.uniform(-120, 120, (B, 33)), rng.uniform(0.1, 0.7, (B, 15)),
        rng.uniform(-180, 180, (B, 3)), rng.normal(size=(B, 3)),
        rng.normal(size=(B, 16, 3)))]


def _misaligned(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` whose data starts 4 bytes past a 16-byte boundary."""
    buf = np.empty(a.size + 4, np.float32)
    skip = (4 - buf.ctypes.data % 16 // 4) % 4 + 1
    out = buf[skip:skip + a.size].reshape(a.shape)
    out[...] = a
    assert out.ctypes.data % 16 == 4
    return out


def _forward(lib, ang, bl, grot, root, out=None):
    out = np.zeros((ang.shape[0], 16, 3), np.float32) if out is None else out
    lib.fk_forward_host(_ptr(ang), _ptr(bl), _ptr(grot), _ptr(root), _ptr(out), ang.shape[0])
    return out


def _backward(lib, ang, bl, grot, cot):
    B = ang.shape[0]
    outs = [np.zeros((B, n), np.float32) for n in (33, 15, 3, 3)]
    lib.fk_backward_host(_ptr(ang), _ptr(bl), _ptr(grot), _ptr(cot),
                         *[_ptr(o) for o in outs], B)
    return outs


def _autograd(ang, bl, grot, root, cot):
    t_in = [torch.tensor(a, requires_grad=True) for a in (ang, bl, grot, root)]
    return torch.autograd.grad(t_fk.fk_world_pose_16(*t_in), t_in, torch.from_numpy(cot))


# B = 1, 96, 513 and the ragged last tiles TILE + 1 and 3 TILE - 1
@pytest.mark.parametrize("B", [1, 96, 513, TILE + 1, 3 * TILE - 1])
def test_forward_matches_plain_fk(host_lib, B):
    ang, bl, grot, root, _ = _inputs(B, B)
    out = _forward(host_lib, ang, bl, grot, root)
    ref = t_fk.fk_world_pose_16(*[torch.from_numpy(a) for a in (ang, bl, grot, root)])
    np.testing.assert_allclose(out, ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("B", [1, 64, 70, TILE + 1, 3 * TILE - 1])
def test_backward_matches_autograd(host_lib, B):
    ang, bl, grot, root, cot = _inputs(B + 100, B)
    outs = _backward(host_lib, ang, bl, grot, cot)
    ref = _autograd(ang, bl, grot, root, cot)
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
        outs = _backward(host_lib, ang, bl, grot, cot)
        dbl = _autograd(ang, bl, grot, root, cot)[1]
        np.testing.assert_allclose(outs[1], dbl.numpy(), atol=1e-6, rtol=1e-5)
        assert np.abs(dbl.numpy()).max() > 0.1


@pytest.mark.parametrize("slot", range(16))
def test_backward_one_hot_joint_cotangent(host_lib, slot):
    """The Jacobian form joint by joint: a cotangent on one output joint only
    must reach exactly the links upstream of it.  The hand joints (slots
    10-15) show the arms' sums entering body links 0-8."""
    B = TILE + 3
    ang, bl, grot, root, _ = _inputs(200 + slot, B)
    cot = np.zeros((B, 16, 3), np.float32)
    cot[:, slot] = np.random.default_rng(slot).normal(size=(B, 3))
    outs = _backward(host_lib, ang, bl, grot, cot)
    ref = _autograd(ang, bl, grot, root, cot)
    for name, r, g in zip(("dangles", "dbone_len", "dglobal_rot", "droot"), ref, outs):
        np.testing.assert_allclose(g, r.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)
        # the links downstream of the joint get exactly zero, as in autograd
        np.testing.assert_array_equal(g == 0, r.numpy() == 0, err_msg=name)


def test_misaligned_inputs_take_the_scalar_path(host_lib):
    """Inputs and outputs 4 bytes past a 16-byte boundary give the same
    numbers as aligned ones: the vector and scalar copies agree bit for
    bit."""
    B = 2 * TILE + 5
    ang, bl, grot, root, cot = _inputs(31, B)
    mis = [_misaligned(a) for a in (ang, bl, grot, root, cot)]
    out = _misaligned(np.zeros((B, 16, 3), np.float32))
    np.testing.assert_array_equal(_forward(host_lib, *mis[:4], out=out),
                                  _forward(host_lib, ang, bl, grot, root))
    for got, want in zip(_backward(host_lib, mis[0], mis[1], mis[2], mis[4]),
                         _backward(host_lib, ang, bl, grot, cot)):
        np.testing.assert_array_equal(got, want)


def test_sincos_is_rounded_from_double(host_lib):
    """The kernels' sin/cos: the float argument's sin and cos in double,
    rounded to float, for every argument the FK forms from angles within
    +-720 degrees (and the Euler angles'), where sinf and cosf carry up to
    2 ulp."""
    deg = np.arange(-720.0, 720.0, 0.0625, dtype=np.float32)
    x = np.ascontiguousarray(deg * np.float32(np.pi / 180))
    s, c = np.zeros_like(x), np.zeros_like(x)
    host_lib.sincos_host(_ptr(x), _ptr(s), _ptr(c), x.size)
    xd = x.astype(np.float64)
    np.testing.assert_array_equal(s, np.sin(xd).astype(np.float32))
    np.testing.assert_array_equal(c, np.cos(xd).astype(np.float32))


@pytest.mark.parametrize("B", [TILE * 4 + 3])
def test_matches_pallas_kernels_in_interpret_mode(host_lib, B):
    """Forward and backward against the JAX package's Pallas kernels B1/B2
    (interpret mode)."""
    ang, bl, grot, root, cot = _inputs(B + 50, B)
    ref = np.asarray(fk_world_pose_pallas(*[jnp.asarray(a) for a in (ang, bl, grot, root)],
                                          interpret=True))
    np.testing.assert_allclose(_forward(host_lib, ang, bl, grot, root), ref, atol=1e-5, rtol=0)
    ref_grads = fk_bwd_pallas(*[jnp.asarray(a) for a in (ang, bl, grot, cot)], interpret=True)
    for name, r, g in zip(("dangles", "dbone_len", "dglobal_rot", "droot"), ref_grads,
                          _backward(host_lib, ang, bl, grot, cot)):
        np.testing.assert_allclose(g, np.asarray(r), atol=1e-5, rtol=1e-4, err_msg=name)
