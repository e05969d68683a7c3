"""CUDA kernel tests of dhaug_torch: they need an NVIDIA card and skip
elsewhere.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import os

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
# video mode's clip batches B x F: 512 x 9 (the README's --architecture 3,3
# --batch_size 512), 512 x 27 (the default 3,3,3) and 8 x 9 (a ragged last
# tile of 8); "1027m": inputs 4 bytes past a 16-byte boundary; and a rank's
# rows of two data-parallel ranks: 512 (the training batch 1024), 2304 (the
# video clip batch 4608) and 4096 (the synthesis batch 8192); the
# benchmark's synthesis batch 65536; and 512 x 81, PoseFormer's published
# receptive field (--architecture 3,3,3,3 --batch_size 512)
FK_CASES = [1, 1000, 1024, 1027, 8192, 10000, "1027m", 72, 4608, 13824, 512, 2304, 4096,
            65536, 41472]


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


def test_video_gan_steps_run_on_both_kernels(device):
    """One video critic phase (motion critics and playback on) and one
    generator update at 8 clips of 9 frames: B1 once for the critics'
    fakes, B1 and B2 once for the generator; outputs finite and shaped."""
    from dhaug_torch.gan.video import VideoSteps
    from dhaug_torch.gan.wgan import GanHyper, camera_bank
    from dhaug_torch.models import discriminators as disc
    from dhaug_torch.train.state import adam_gan
    B, F, W = 8, 9, 64
    torch.manual_seed(0)
    cfg = GeneratorConfig(dense_dim=W, video_frames=F)
    nets = [FkGeneratorNet(cfg), disc.Fk3DDiscriminator(W), disc.Fk2DDiscriminator(W),
            disc.MotionFk3DDiscriminator(F, W), disc.MotionFk2DDiscriminator(F, W)]
    nets = [n.to(device) for n in nets]
    steps = VideoSteps(*nets, *[adam_gan(n.parameters()) for n in nets], cfg, GanHyper(),
                       *camera_bank(["S1"], device), playback=True)
    g = torch.Generator(device=device).manual_seed(0)
    rng = np.random.default_rng(0)
    ang, bl, grot, root, _ = _inputs(B * F, 3, device)
    with torch.no_grad():
        clip3d = (fk_cuda.fk_world_pose_16(ang * 0.2, bl, grot * 0.1, root * 0.1)
                  + torch.tensor([0.0, 0.0, 5.0], device=device)).reshape(B, F, 16, 3)
    cam16 = torch.cat([steps.cam_intrs[0], steps.cam_quats[0], steps.cam_trans[0]]).expand(B, 16)
    clip2d = torch.as_tensor(rng.normal(size=(B, F, 16, 2)) * 0.3, dtype=torch.float32,
                             device=device)
    f0, b0 = fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES
    cam_idx, bone_len, f3d, f2d, intr, metrics = steps.critics_step(clip3d, cam16, clip2d, g,
                                                                    use_motion=True)
    assert (fk_cuda.FWD_LAUNCHES - f0, fk_cuda.BWD_LAUNCHES - b0) == (1, 0)
    out = steps.generator_step(bone_len, cam_idx, g, use_motion=True)
    torch.cuda.synchronize()
    assert (fk_cuda.FWD_LAUNCHES - f0, fk_cuda.BWD_LAUNCHES - b0) == (2, 1)
    assert f3d.shape == (B, F, 16, 3) and f2d.shape == (B, F, 16, 2) and intr.shape == (B, F, 9)
    assert bool(torch.isfinite(f3d).all()) and bool(torch.isfinite(f2d).all())
    assert {"motion_3d_wasserstein", "motion_2d_wasserstein"} <= set(metrics)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert bool(torch.isfinite(out["g_cost"]))


def test_poseformer_train_step_matches_the_reference(device):
    """One PoseFormer optimizer step at its published widths (embed 32,
    depth 4, 8 heads, MLP ratio 2, drop path 0.1) on 512 clips of 81
    frames, the program's ``train_step`` against the plain float32
    reference (``benchmark/reference/poseformer.py``) from the same weights,
    clips and generator.  Both run the same float32 products with TF32 off
    and draw the same stochastic depth masks, so they part only where a
    reduction sums in another order: the loss to 1e-5, each gradient and
    each stepped weight to 1e-4 of its leaf's largest gradient or
    weight."""
    from benchmark.reference.nets import init_weights
    from benchmark.reference.poseformer import PoseFormer as Reference
    from benchmark.reference.steps import posenet_step
    from dhaug_torch.models.factory import make_posenet
    from dhaug_torch.train.posenet import train_step
    from dhaug_torch.train.state import adam_posenet

    assert not torch.backends.cuda.matmul.allow_tf32
    net = make_posenet("mulit_farme_poseformer", architecture="3,3,3,3", flag="train")
    ref = Reference(81)
    nets = [net.to(device), ref.to(device)]
    for n in nets:
        init_weights([n], torch.Generator(device=device).manual_seed(1))
    g = torch.Generator(device=device).manual_seed(2)
    x = 0.3 * torch.randn(512, 81, 16, 2, generator=g, device=device)
    y = 0.2 * torch.randn(512, 1, 16, 3, generator=g, device=device)
    y = y - y[..., :1, :]
    opt, ref_opt = adam_posenet(net.parameters()), adam_posenet(ref.parameters())
    loss = train_step(net, opt, x, y, 1.0, torch.Generator(device=device).manual_seed(3),
                      "mpjpe")
    ref_loss = posenet_step(ref, ref_opt, x, y, 1.0, torch.Generator(device=device).manual_seed(3))
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=0)
    for (name, p), (ref_name, r) in zip(net.named_parameters(), ref.named_parameters()):
        assert name == ref_name
        for a, b in ((p.grad, r.grad), (p.detach(), r.detach())):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-12,
                                       msg=lambda m, name=name: f"{name}: {m}")


def _trunk(dense, device, seed=0):
    torch.manual_seed(seed)
    return trunk_cuda.trunk_weights(FkGeneratorNet(GeneratorConfig(dense_dim=dense)).to(device))


@pytest.mark.parametrize("dense,B", [(1000, 8192), (1000, 1000), (1000, 1), (40, 1000),
                                     (64, 64), (256, 333), (1000, 4096), (1000, 65536)])
def test_trunk_kernel_matches_plain(device, dense, B):
    """B3 against the plain bf16 trunk, to the bf16-level rule of
    trunk_cuda.TRUNK_MAX_ERR / TRUNK_MEAN_ERR: the synthesis width at full,
    ragged and single-row batches, one tile (D = 64, B = 64: a swizzle or
    descriptor mismatch shows here first), ragged rows over several tiles
    (D = 256, B = 333), a rank's rows of a 2-process synthesis
    (B = 4096) and the benchmark's synthesis batch (B = 65536: 256 MB of
    fp32 scratch)."""
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


@pytest.mark.parametrize("dense", [64, 1000])
@pytest.mark.parametrize("B", [1, 63, 8192, 65536 + 37])
def test_persistent_trunk_matches_plain(device, dense, B):
    """The persistent schedule at a single row, one ragged tile, a batch
    of several tiles a block and the synthesis batch with a ragged last
    tile, at one column tile (D = 64) and at the synthesis width."""
    ops = _trunk(dense, device, seed=B)
    noise = torch.as_tensor(np.random.default_rng(B + dense).normal(size=(B, 128)),
                            dtype=torch.float32, device=device)
    out = trunk_cuda.trunk_forward_cuda(ops, noise)
    torch.cuda.synchronize()
    assert out.shape == (B, 35) and bool(torch.isfinite(out).all())
    max_err, mean_err = trunk_cuda.trunk_errors(out, trunk_cuda.trunk_reference_bf16(ops, noise))
    assert max_err <= trunk_cuda.TRUNK_MAX_ERR and mean_err <= trunk_cuda.TRUNK_MEAN_ERR


def test_trunk_rows_do_not_depend_on_the_batch_around_them(device):
    """A row's sums run in one k order whatever tile and block take it, so
    the rows of one 65536-row call equal, bit for bit, the same rows
    computed in calls of 8192."""
    ops = _trunk(1000, device)
    noise = torch.as_tensor(np.random.default_rng(5).normal(size=(65536, 128)),
                            dtype=torch.float32, device=device)
    whole = trunk_cuda.trunk_forward_cuda(ops, noise)
    parts = torch.cat([trunk_cuda.trunk_forward_cuda(ops, noise[i:i + 8192].contiguous())
                       for i in range(0, 65536, 8192)])
    torch.cuda.synchronize()
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("B", [65536, 8192, 256])
def test_trunk_counters_show_the_persistent_schedule(device, B):
    """TRUNK_TILES and TRUNK_BLOCKS: at the synthesis batches each block
    walks several 64-row tiles of a D x D layer, at most one block an SM;
    with fewer tiles than SMs each block takes one."""
    ops = _trunk(1000, device)
    trunk_cuda.trunk_forward_cuda(ops, torch.randn(B, 128, device=device))
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles, blocks = trunk_cuda.TRUNK_TILES, trunk_cuda.TRUNK_BLOCKS
    assert tiles == B // 64 * 4  # 1024 columns in 256-wide tiles
    assert 1 <= blocks <= min(tiles, sms)
    if tiles > sms:
        assert tiles >= 3 * blocks
    else:
        assert blocks == tiles


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


def test_synthesis_dispatch_makes_no_host_synchronization(device):
    """After a warm-up dispatch (the generator's constant tables uploaded
    once on the card), three dispatches of the synthesis body and the
    generator's two table users alone run under the sync debug mode
    "error": nothing in them synchronizes the host with the card."""
    from dhaug_torch import synthesize_dataset
    from dhaug_torch.gan.wgan import camera_bank
    from dhaug_torch.models import generator
    from dhaug_torch.ops.fk import CANONICAL_BONE_LEN
    from dhaug_torch.parallel.sharded import make_sharded_synthesizer

    B = 4096
    cfg = GeneratorConfig()
    ops = _trunk(cfg.dense_dim, device)
    synthesize = make_sharded_synthesizer(cfg)
    cameras = camera_bank(["S1", "S5", "S6", "S7", "S8"], device)
    bone_len = torch.tensor(CANONICAL_BONE_LEN, dtype=torch.float32,
                            device=device).expand(B, 15).contiguous()
    g = torch.Generator(device=device).manual_seed(1)
    head = torch.randn(B, 35, device=device)
    scaler8 = torch.zeros(B, 8, device=device)
    synthesize_dataset.synth_pairs(synthesize, ops, bone_len, cameras, g)
    torch.cuda.synchronize()
    t0 = trunk_cuda.TRUNK_LAUNCHES
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [synthesize_dataset.synth_pairs(synthesize, ops, bone_len, cameras, g)
                for _ in range(3)]
        generator.head_to_angles(head, cfg)
        generator.scale_bone_lengths(bone_len, scaler8)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert trunk_cuda.TRUNK_LAUNCHES == t0 + 3
    assert all(o[0].shape == (B, 16, 3) and bool(torch.isfinite(o[1]).all()) for o in outs)


def test_bf16_trunk_gan_step_runs_on_both_kernels(device):
    """A single-frame critic phase and generator update with the bf16 trunk
    (--bf16_trunk) at batch 256, width 64: the trunk computes in bf16 on
    fp32 weights, B1 runs once for the critics' fakes and B1 + B2 once for
    the generator update, every output finite; the generator's gradient
    reaches its fp32 weights."""
    from dhaug_torch.gan.wgan import GanHyper, SingleFrameSteps, camera_bank
    from dhaug_torch.models import discriminators as disc
    from dhaug_torch.train.state import adam_gan
    B, W = 256, 64
    torch.manual_seed(0)
    cfg = GeneratorConfig(dense_dim=W, bf16_trunk=True)
    nets = [n.to(device) for n in (FkGeneratorNet(cfg), disc.Fk3DDiscriminator(W),
                                   disc.Fk2DDiscriminator(W))]
    steps = SingleFrameSteps(*nets, *[adam_gan(n.parameters()) for n in nets], cfg,
                             GanHyper(), *camera_bank(["S1"], device))
    head = steps.gen(torch.randn(B, 128, device=device))
    assert head.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in steps.gen.parameters())
    g = torch.Generator(device=device).manual_seed(0)
    ang, bl, grot, root, _ = _inputs(B, 5, device)
    with torch.no_grad():
        real = (fk_cuda.fk_world_pose_16(ang * 0.2, bl, grot * 0.1, root * 0.1)
                + torch.tensor([0.0, 0.0, 5.0], device=device))
    cam16 = torch.cat([steps.cam_intrs[0], steps.cam_quats[0], steps.cam_trans[0]]).expand(B, 16)
    target_2d = torch.as_tensor(np.random.default_rng(0).normal(size=(B, 16, 2)) * 0.3,
                                dtype=torch.float32, device=device)
    before = [p.detach().clone() for p in steps.gen.parameters()]
    f0, b0 = fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES
    cam_idx, bone_len, f3d, f2d, _, metrics = steps.critics_step(real, cam16, target_2d, g)
    assert (fk_cuda.FWD_LAUNCHES - f0, fk_cuda.BWD_LAUNCHES - b0) == (1, 0)
    out = steps.generator_step(bone_len, cam_idx, g)
    torch.cuda.synchronize()
    assert (fk_cuda.FWD_LAUNCHES - f0, fk_cuda.BWD_LAUNCHES - b0) == (2, 1)
    assert bool(torch.isfinite(f3d).all()) and bool(torch.isfinite(f2d).all())
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert bool(torch.isfinite(out["g_cost"]))
    assert all(not torch.equal(a, p) for a, p in zip(before, steps.gen.parameters()))


def test_synthetic_fixture_written_on_the_card_equals_the_committed_one(device, tmp_path):
    """ensure_synthetic_dataset with the FK on the card writes the files the
    repo holds: 3D and 3DHP to 1e-5 m (3DHP 2D to 1e-5), pixels to 1e-2,
    templates to 1e-6 m."""
    import os
    from dhaug_torch.data.synthetic import ensure_synthetic_dataset, fixture_differences
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ensure_synthetic_dataset(str(tmp_path), device="cuda")
    diffs = fixture_differences(str(tmp_path), repo)
    tol = {"data_3d_h36m.npz/positions_3d": 1e-5, "data_2d_h36m_gt.npz/positions_2d": 1e-2,
           "data_2d_h36m_cpn.npz/positions_2d": 1e-2, "test_3dhp.npz/pose3d": 1e-5,
           "test_3dhp.npz/pose2d": 1e-5, "hm36s15678_bl_templates.npy/lengths": 1e-6}
    assert set(diffs) == set(tol)
    assert all(diffs[k] <= tol[k] for k in tol), diffs


def test_two_gloo_ranks_on_one_card_equal_one_rank(device):
    """One critic phase (B1 on each rank's rows) and one generator update
    (B1 and B2) with SGD on two gloo ranks sharing cuda:0, against one rank,
    with the bounds of tests/test_torch_parallel.py: weights within 1e-6
    (critics) and 1e-5 (generator), fakes and scalars within 1e-6."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_dp_worker as worker
    from dhaug_torch.gan.wgan import camera_bank
    from dhaug_torch.parallel import mesh

    B, W, subjects = 64, 64, ["S1", "S5"]
    rng = np.random.default_rng(3)
    real = fk_plain.fk_world_pose_16(*(torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.uniform(-30, 30, (B, 33)), np.asarray(fk_plain.CANONICAL_BONE_LEN) *
        rng.uniform(0.9, 1.1, (B, 15)), rng.uniform(-30, 30, (B, 3)),
        np.broadcast_to([0.0, 0.0, 5.0], (B, 3))))).numpy()
    quats, trans, intrs = (np.asarray(x) for x in camera_bank(subjects))
    cam16 = np.tile(np.concatenate([intrs[2], quats[2], trans[2]]), (B, 1)).astype(np.float32)
    batch = (real, cam16, (rng.normal(size=(B, 16, 2)) * 0.3).astype(np.float32))
    f32 = lambda a: np.asarray(a, np.float32)
    draws = dict(noise=f32(rng.normal(size=(B, 128))),
                 scaler8=f32(rng.integers(-200, 200, (B, 8)) / 1000.0), cam_idx=5,
                 alphas=[f32(rng.uniform(size=(B, 1))) for _ in range(4)])
    gen_inputs = dict(bone_len=f32(rng.uniform(0.15, 0.6, (B, 15))), cam_idx=3,
                      noise=f32(rng.normal(size=(B, 128))),
                      scaler8=f32(rng.integers(-200, 200, (B, 8)) / 1000.0))
    args = (W, subjects, None, 1e-6, None, 1e-2, batch, draws, gen_inputs, "cuda:0")
    one = worker.gan_step_phases(*args)
    ranks = mesh.launch("test_torch_dp_worker:gan_step_phases", args, ["cuda:0", "cuda:0"],
                        "gloo")
    for r in ranks:
        # each rank made its fakes with B1 and updated the generator with B1/B2
        assert r["launches"]["fwd"] >= 2 and r["launches"]["bwd"] == 1
        for net, tol in (("d3d", 1e-6), ("d2d", 1e-6), ("gen", 1e-5)):
            for k, v in one[net].items():
                np.testing.assert_allclose(r[net][k], v, atol=tol, rtol=0, err_msg=k)
        for k in ("fake3d", "fake2d", "bone_len"):
            np.testing.assert_allclose(r[k], one[k], atol=1e-6, rtol=0, err_msg=k)
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, atol=1e-6, rtol=1e-6, err_msg=k)


def test_visualize_fk_sweep_is_one_b1_launch(device, tmp_path):
    """The viewer's whole sweep goes through one B1 launch, within 1e-6 m
    of the plain FK on the same inputs."""
    from dhaug_torch import visualize_fk
    out = visualize_fk.main(["--sweep", "3", "--out", str(tmp_path / "knee.png")])
    assert out["launches"] == 1 and os.path.getsize(out["path"]) > 0
    n = len(out["angles"])
    rows = lambda v: torch.tensor(v, dtype=torch.float32, device=device).expand(n, -1)
    plain = fk_plain.fk_world_pose_16(torch.as_tensor(out["angles"], device=device),
                                      rows(fk_plain.CANONICAL_BONE_LEN), rows([0.0] * 3),
                                      rows([0.0] * 3))
    np.testing.assert_allclose(out["poses"], plain.cpu().numpy(), atol=1e-6, rtol=0)


def test_inspector_goldens_come_from_b1(device, tmp_path):
    """The inspector's four goldens are one B1 launch, within 1e-6 m of the
    plain FK plus the page's 6-decimal rounding."""
    import json
    import re

    from dhaug_torch import make_fk_inspector
    n0 = fk_cuda.FWD_LAUNCHES
    path = make_fk_inspector.generate(str(tmp_path / "insp.html"), device)
    assert fk_cuda.FWD_LAUNCHES == n0 + 1
    spec = json.loads(re.search(r"const SPEC = (\{.*?\});\n", open(path).read(),
                                re.S).group(1))
    assert len(spec["goldens"]) == 4 and len(spec["scatter16"]) == 16
    as_rows = lambda key: torch.tensor([g[key] for g in spec["goldens"]], device=device)
    plain = fk_plain.fk_world_pose_16(as_rows("angles"), as_rows("bone_len"),
                                      as_rows("global_rot"), torch.zeros(4, 3, device=device))
    np.testing.assert_allclose(np.asarray([g["pose"] for g in spec["goldens"]]),
                               plain.cpu().numpy(), atol=1e-6 + 5e-7, rtol=0)


def test_prepare_h36m_projection_on_the_card_equals_the_cpu(device):
    """The H36M prep's 2D projection on the card within 1e-3 px of the same
    function on the CPU (pixels reach ~1000 px, where a float32 ulp is
    ~6e-5), in the file's layout: 4 float32 host arrays a sequence."""
    from dhaug_torch.data.synthetic import random_fk_poses
    from dhaug_torch.prepare_data_h36m import project_positions_2d
    rng = np.random.default_rng(3)
    positions_3d = {s: {a: random_fk_poses(rng, 700, device) for a in ("Walking", "Eating 1")}
                    for s in ("S1", "S11")}
    got = project_positions_2d(positions_3d, device)
    want = project_positions_2d(positions_3d, "cpu")
    for s, actions in want.items():
        for a, cams in actions.items():
            assert len(got[s][a]) == 4
            for g, w in zip(got[s][a], cams):
                assert isinstance(g, np.ndarray) and g.dtype == np.float32
                assert g.shape == (700, 16, 2) and np.isfinite(g).all()
                np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_bench_prints_three_lines_naming_the_card(device):
    """``python -m dhaug_torch.bench`` at small widths with short repeats:
    three JSON lines, video, GAN, synthesis; the first two name this card
    and its power limit, the last holds exactly metric, value, unit and
    vs_baseline."""
    import json
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "dhaug_torch.bench", "--batch", "8192", "--scan_steps", "2",
         "--iters", "1", "--dense", "256", "--gan_scan", "5", "--gan_iters", "1",
         "--video_batch", "64", "--video_batches", "5", "--video_reps", "1",
         "--baseline_iters", "2"], capture_output=True, text=True, cwd=repo, timeout=600,
        env={**os.environ, "PYTHONPATH": repo})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [line["metric"].split(" ")[0] for line in lines] == ["video", "GAN", "augmented"]
    kind = torch.cuda.get_device_name(0)
    for line in lines[:2]:
        assert line["device"]["name"] == kind and kind in line["device"]["nvidia_smi"]
        assert line["value"] > 0 and line["vs_baseline"] > 0 and line["mfu_counted"] > 0
    assert set(lines[-1]) == {"metric", "value", "unit", "vs_baseline"}
    assert lines[-1]["value"] > 0 and lines[-1]["vs_baseline"] > 0


def test_device_kernels_equal_key_averages(device):
    """``utils/profiling.device_kernels`` reads the raw kineto events: the
    same names, counts and summed device µs as ``key_averages()``'s
    device-side entries without user annotations."""
    from torch.profiler import ProfilerActivity, profile

    from dhaug_torch.utils.profiling import device_kernels
    ang, bl, grot, root, cot = _inputs(1024, 5, device)
    a = torch.randn(256, 256, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fk_cuda.fk_forward_cuda(ang, bl, grot, root)
            fk_cuda.fk_backward_cuda(ang, bl, grot, cot)
            torch.relu(a @ a).sum().item()
        torch.cuda.synchronize()
    got = {e.key: (e.self_device_time_total, e.count) for e in device_kernels(prof)}
    want = {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation}
    assert sorted(got) == sorted(want)
    assert [n for key, (_, n) in got.items() if "fk_forward_kernel" in key] == [3]
    for key, (us, count) in want.items():
        assert got[key][1] == count and got[key][0] == pytest.approx(us, rel=1e-9, abs=1e-3)
