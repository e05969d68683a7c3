"""CUDA kernel tests of dhaug_torch: they need an NVIDIA card and skip
elsewhere.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from dhaug_torch.models import trunk_cuda
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
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


def _misaligned(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


# the training batch, ragged ones (1000, and 1027: a last tile of 3 poses),
# the synthesis batch, the traditional augmenter's 10000 (a last tile of 16);
# "1027m": inputs 4 bytes past a 16-byte boundary
FK_CASES = [1, 1000, 1024, 1027, 8192, 10000, "1027m"]


def _fk_case(case, seed_offset, device):
    B = int(str(case).rstrip("m"))
    arrays = _inputs(B, B + seed_offset, device)
    return B, [_misaligned(t) for t in arrays] if str(case).endswith("m") else arrays


@pytest.mark.parametrize("case", FK_CASES)
def test_forward_kernel_matches_plain(device, case):
    B, (ang, bl, grot, root, _) = _fk_case(case, 0, device)
    n0 = fk_cuda.FWD_LAUNCHES
    out = fk_cuda.fk_forward_cuda(ang, bl, grot, root)
    torch.cuda.synchronize()
    assert fk_cuda.FWD_LAUNCHES == n0 + 1
    torch.testing.assert_close(out, fk_plain.fk_world_pose_16(ang, bl, grot, root),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", FK_CASES)
def test_backward_kernel_matches_autograd(device, case):
    B, (ang, bl, grot, root, cot) = _fk_case(case, 1, device)
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


def _trunk(dense, device, seed=0):
    torch.manual_seed(seed)
    return trunk_cuda.trunk_weights(FkGeneratorNet(GeneratorConfig(dense_dim=dense)).to(device))


@pytest.mark.parametrize("dense,B", [(1000, 8192), (1000, 1000), (1000, 1), (40, 1000),
                                     (64, 64), (256, 333)])
def test_trunk_kernel_matches_plain(device, dense, B):
    """B3 against the plain bf16 trunk, to the bf16-level rule of
    trunk_cuda.TRUNK_MAX_ERR / TRUNK_MEAN_ERR: the synthesis width at full,
    ragged and single-row batches, one tile (D = 64, B = 64: a swizzle or
    descriptor mismatch shows here first), and ragged rows over several
    tiles (D = 256, B = 333)."""
    ops = _trunk(dense, device)
    noise = torch.as_tensor(np.random.default_rng(B).normal(size=(B, 128)),
                            dtype=torch.float32, device=device)
    n0 = trunk_cuda.TRUNK_LAUNCHES
    out = trunk_cuda.trunk_forward_cuda(ops, noise)
    torch.cuda.synchronize()
    assert trunk_cuda.TRUNK_LAUNCHES == n0 + 1
    assert out.shape == (B, 35) and bool(torch.isfinite(out).all())
    max_err, mean_err = trunk_cuda.trunk_errors(out, trunk_cuda.trunk_reference_bf16(ops, noise))
    assert max_err <= trunk_cuda.TRUNK_MAX_ERR and mean_err <= trunk_cuda.TRUNK_MEAN_ERR


def test_trunk_wrapper_rejects_bad_tensors(device):
    ops = _trunk(40, device)
    noise = torch.randn(8, 128, device=device)
    with pytest.raises(ValueError, match="dtype"):
        trunk_cuda.trunk_forward_cuda(ops, noise.double())
    with pytest.raises(ValueError, match="contiguous"):
        trunk_cuda.trunk_forward_cuda(ops, torch.cat([noise, noise], 1)[:, ::2])
    with pytest.raises(ValueError, match="16-byte"):
        trunk_cuda.trunk_forward_cuda(ops, torch.randn(8 * 128 + 1, device=device)[1:]
                                      .view(8, 128))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trunk_cuda.trunk_forward_cuda(ops, noise.cpu())
    with pytest.raises(ValueError, match="operand 1: on cpu"):
        trunk_cuda.trunk_forward_cuda((ops[0], ops[1].cpu()) + ops[2:], noise)
    with pytest.raises(ValueError, match="multiples of 64"):  # an unpadded width
        trunk_cuda.trunk_forward_cuda((ops[0][:40].contiguous(),) + ops[1:], noise)
    with pytest.raises(ValueError, match="operand 2: dtype"):
        trunk_cuda.trunk_forward_cuda(ops[:2] + (ops[2].float(),) + ops[3:], noise)


def test_short_synthesis_run_launches_both_kernels(device, tmp_path):
    from dhaug_torch import synthesize_dataset
    f0, t0 = fk_cuda.FWD_LAUNCHES, trunk_cuda.TRUNK_LAUNCHES
    result = synthesize_dataset.main([
        "--device", "cuda", "--random_init", "true", "--Gen_DenseDim", "64",
        "--n_poses", "1000", "--batch", "256", "--out", str(tmp_path / "s.npz")])
    # 1000 poses in batches of 256: 4 batches, one trunk and one FK each
    assert (fk_cuda.FWD_LAUNCHES - f0, trunk_cuda.TRUNK_LAUNCHES - t0) == (4, 4)
    data = np.load(tmp_path / "s.npz")
    assert data["pose3d"].shape == (1000, 16, 3) and np.isfinite(data["pose3d"]).all()
    assert result["n_poses"] == 1000
