"""dhaug_torch plain FK against the JAX FK and the interpret-mode Pallas
kernels, its gradients against jax.grad through the Pallas custom_vjp, and
the CPU routing of the kernel wrappers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch.ops import fk as t_fk
from dhaug_torch.ops import fk_cuda
from dhaug_tpu.ops.fk import CANONICAL_BONE_LEN, FKInputs, fk_world_pose, init_fk_dh_angle
from dhaug_tpu.ops.fk_pallas import fk_world_pose_pallas, fk_world_pose_pallas_vjp


def _inputs(seed, B):
    """As tests/test_fk_pallas.py: angles +-120 deg, bones 0.1-0.7 m."""
    rng = np.random.default_rng(seed)
    return [np.asarray(a, np.float32) for a in (
        rng.uniform(-120, 120, (B, 33)), rng.uniform(0.1, 0.7, (B, 15)),
        rng.uniform(-180, 180, (B, 3)), rng.normal(size=(B, 3)))]


def _torch(arrays, dtype=torch.float32, grad=False):
    return [torch.tensor(a, dtype=dtype, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("B", [96, 513])
def test_forward_matches_jax_and_pallas_interpret(B):
    arrays = _inputs(B, B)
    j = [jnp.asarray(a) for a in arrays]
    ref_xla = np.asarray(fk_world_pose(FKInputs(*j), 16))
    ref_pallas = np.asarray(fk_world_pose_pallas(*j, interpret=True))
    out = t_fk.fk_world_pose_16(*_torch(arrays)).numpy()
    assert out.shape == (B, 16, 3)
    np.testing.assert_allclose(out, ref_xla, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, ref_pallas, atol=1e-5, rtol=0)


def test_32_slot_layout_and_golden_pose():
    arrays = _inputs(3, 8)
    ref = np.asarray(fk_world_pose(FKInputs(*[jnp.asarray(a) for a in arrays]), 32))
    np.testing.assert_allclose(t_fk.fk_world_pose(*_torch(arrays)).numpy(), ref, atol=1e-5)
    zero = torch.zeros(33)
    golden = t_fk.fk_world_pose(zero, torch.tensor(CANONICAL_BONE_LEN), torch.zeros(3),
                                torch.zeros(3))
    np.testing.assert_allclose(golden.numpy(), np.asarray(init_fk_dh_angle()), atol=1e-6)


def _grad_weights(seed):
    return np.random.default_rng(seed).normal(size=(16, 3)).astype(np.float32)


@pytest.mark.parametrize("B", [64, 70])
def test_gradients_match_pallas_custom_vjp(B):
    arrays = _inputs(B + 7, B)
    w = _grad_weights(B)
    j = [jnp.asarray(a) for a in arrays]
    ref = jax.grad(lambda a, b, g, r: jnp.sum(
        fk_world_pose_pallas_vjp(a, b, g, r, interpret=True) * w),
        argnums=(0, 1, 2, 3))(*j)
    t_in = _torch(arrays, grad=True)
    got = torch.autograd.grad((t_fk.fk_world_pose_16(*t_in) * torch.from_numpy(w)).sum(), t_in)
    for name, r, g in zip(("dangles", "dbone_len", "dglobal_rot", "droot"), ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_gradcheck_float64():
    arrays = _inputs(11, 3)
    t_in = _torch(arrays, dtype=torch.float64, grad=True)
    assert torch.autograd.gradcheck(t_fk.fk_world_pose_16, t_in, eps=1e-6, atol=1e-5)


def test_wrapper_on_cpu_takes_the_plain_fk_and_launches_nothing():
    fwd0, bwd0 = fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES
    arrays = _inputs(12, 16)
    t_in = _torch(arrays, grad=True)
    out = fk_cuda.fk_world_pose_16(*t_in)
    ref = t_fk.fk_world_pose_16(*_torch(arrays))
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)
    out.sum().backward()
    assert all(t.grad is not None for t in t_in)
    assert (fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES) == (fwd0, bwd0)


def test_kernel_entry_points_refuse_cpu_tensors():
    arrays = _torch(_inputs(13, 4))
    with pytest.raises(ValueError, match="CUDA"):
        fk_cuda.fk_forward_cuda(*arrays)
    with pytest.raises(ValueError, match="CUDA"):
        fk_cuda.fk_backward_cuda(*arrays[:3], torch.zeros(4, 16, 3))
