"""CUDA kernel tests of dhaug_torch: they need an NVIDIA card and skip
elsewhere.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from dhaug_torch.ops import fk as fk_plain
from dhaug_torch.ops import fk_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _inputs(B, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-120, 120, (B, 33)), rng.uniform(0.1, 0.7, (B, 15)),
              rng.uniform(-180, 180, (B, 3)), rng.normal(size=(B, 3)),
              rng.normal(size=(B, 16, 3)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.parametrize("B", [1, 1000, 1024])
def test_forward_kernel_matches_plain(device, B):
    ang, bl, grot, root, _ = _inputs(B, B, device)
    n0 = fk_cuda.FWD_LAUNCHES
    out = fk_cuda.fk_forward_cuda(ang, bl, grot, root)
    torch.cuda.synchronize()
    assert fk_cuda.FWD_LAUNCHES == n0 + 1
    torch.testing.assert_close(out, fk_plain.fk_world_pose_16(ang, bl, grot, root),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("B", [1, 1000, 1024])
def test_backward_kernel_matches_autograd(device, B):
    ang, bl, grot, root, cot = _inputs(B, B + 1, device)
    inputs = [t.clone().requires_grad_(True) for t in (ang, bl, grot, root)]
    ref = torch.autograd.grad(fk_plain.fk_world_pose_16(*inputs), inputs, cot)
    n0 = fk_cuda.BWD_LAUNCHES
    got = fk_cuda.fk_backward_cuda(ang, bl, grot, cot)
    torch.cuda.synchronize()
    assert fk_cuda.BWD_LAUNCHES == n0 + 1
    for r, g in zip(ref, got):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_autograd_function_routes_through_both_kernels(device):
    ang, bl, grot, root, cot = _inputs(64, 5, device)
    inputs = [t.clone().requires_grad_(True) for t in (ang, bl, grot, root)]
    f0, b0 = fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES
    out = fk_cuda.fk_world_pose_16(*inputs)
    grads = torch.autograd.grad(out, inputs, cot)
    assert (fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES) == (f0 + 1, b0 + 1)
    ref_in = [t.clone().requires_grad_(True) for t in (ang, bl, grot, root)]
    ref = torch.autograd.grad(fk_plain.fk_world_pose_16(*ref_in), ref_in, cot)
    for r, g in zip(ref, grads):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        fk_cuda.fk_world_pose_16(*inputs)
    assert (fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES) == (f0 + 2, b0 + 1)


def test_wrapper_rejects_bad_tensors(device):
    ang, bl, grot, root, _ = _inputs(8, 6, device)
    with pytest.raises(ValueError, match="dtype"):
        fk_cuda.fk_forward_cuda(ang.double(), bl, grot, root)
    with pytest.raises(ValueError, match="contiguous"):
        fk_cuda.fk_forward_cuda(torch.cat([ang, ang], 1)[:, ::2], bl, grot, root)
    with pytest.raises(ValueError, match="shape"):
        fk_cuda.fk_forward_cuda(ang, bl[:, :14].contiguous(), grot, root)
    with pytest.raises(ValueError, match="on cpu"):
        fk_cuda.fk_forward_cuda(ang, bl.cpu(), grot, root)


def test_short_training_run_launches_both_kernels(device, tmp_path):
    from dhaug_torch import run_fk_gan
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    f0, b0 = fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES
    out = run_fk_gan.main([
        "--posenet_name", "mlp", "--batch_size", "512", "--epochs", "2",
        "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
        "--Gen_DenseDim", "64", "--Dis_DenseDim_3D", "64", "--Dis_DenseDim_2D", "64",
        "--device", "cuda", "--data_root", repo, "--checkpoint", str(tmp_path)])
    # 4800 fixture frames // 512 = 9 GAN iterations an epoch, 18 in all:
    # 18 critic-phase forwards and generator updates at iterations 4, 9, 14
    assert fk_cuda.FWD_LAUNCHES - f0 == 18 + 3
    assert fk_cuda.BWD_LAUNCHES - b0 == 3
    assert all(np.isfinite(v) for v in out["scores"]["h36m"].values())
