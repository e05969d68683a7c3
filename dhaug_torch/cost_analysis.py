"""FLOP counts of the GAN iterations: by hand from the shapes, and counted.

Counterpart of ``scripts/cost_analysis.py``, which reads XLA's cost
analysis of the compiled steps; PyTorch has no compiler count, so this
module runs one ``critics_step`` and one ``generator_step`` of the port
(``gan/wgan.py``, ``gan/video.py``) under
``torch.utils.flop_counter.FlopCounterMode``, which counts every matmul,
convolution and attention op the dispatcher sees: the forwards, the
backwards and the gradient penalty's double backward.  It counts no
elementwise work (XLA's count does), and it cannot see the FK kernels B1
and B2, whose ctypes launches bypass the dispatcher: their work is left
out of the count, and their hand count (``fk_cuda.FWD_FLOP_PER_POSE`` /
``BWD_FLOP_PER_POSE`` a pose) is reported beside it.  On the CPU the
plain FK runs instead, and its small 3 x 3 matmuls are counted.

One GAN iteration is a critics step every iteration and a generator step
every 5th (model_fk_gan_train.py:415), so a count per iteration is
critics + generator / 5.

The hand counts (:func:`gan_iter_flops`, :func:`video_iter_flops`) are
copies of ``bench.py``'s ``_gan_iter_flops`` / ``_video_iter_flops``:
dense layers only, a deliberate undercount that ``dhaug_torch.bench``
reports as ``mfu_lower_bound``.

    python -m dhaug_torch.cost_analysis [--ms_single 45.8] [--ms_video 275.5]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

import dhaug_torch
from dhaug_torch.gan.single_frame import build_gan
from dhaug_torch.gan.video import build_video_gan
from dhaug_torch.gan.wgan import camera_bank, tiled_cam16
from dhaug_torch.ops.fk_cuda import BWD_FLOP_PER_POSE, FWD_FLOP_PER_POSE
from dhaug_torch.train.config import parse_aug_args
from dhaug_torch.train.data_prep import train_subject_list
from dhaug_torch.utils.profiling import PEAK_FP32_FLOP_S, device_name

# XLA's count of the JAX package's steps at the production shapes
# (bench.py:79-80, ``python scripts/cost_analysis.py --cpu``): elementwise
# work included, FK through XLA's lowering
XLA_GFLOPS_PER_GAN_ITER = 1246.4      # single_frame_iter(B=1024)
XLA_GFLOPS_PER_VIDEO_ITER = 8369.6    # video_iter(B=512, F=9)


def tower_fwd(B, in_dim, d, out_dim):
    """Dense-matmul FLOPs of one ResTower forward (prelude in->d, 3 residual
    blocks of 2 Dense(d) layers, final d->out) on a batch of B rows."""
    return 2.0 * B * (in_dim * d + 6 * d * d + d * out_dim)


def video_iter_flops(B: int, F: int, dense: int) -> float:
    """Analytic matmul-FLOP UNDERCOUNT of one VIDEO GAN training iteration
    (the 12-critic-update block + 1/5 of the 4-critic generator update) at
    the production shapes: dense layers only; FK, projection, KCS assembly
    and elementwise work ignored.

    Per critic update: 3 forwards (real, fake, GP interpolates), the loss
    backward (~2x fwd) and the GP double-backward (~2x the GP branch) =>
    ~9 fwd-equivalents.  Updates per iteration: the single-frame 3D/2D
    critics see the clip as B*F frames and update twice each (flip); the
    motion critics see B clips and update four times each (flip x
    playback) => 12 updates."""
    d = dense
    BF = B * F
    # single-frame critics on B*F frames
    d3d_fwd = tower_fwd(BF, 30, d, 1) + tower_fwd(BF, 48, d, 1) + \
        2.0 * BF * (2 * d * 100 + 100 * 1)
    d2d_fwd = 2.0 * BF * (32 * d + 4 * d * d + d * 1)
    # motion critics on B clips (all four md3d branches on; md2d 2 branches)
    md3d_fwd = sum(tower_fwd(B, i, d, 1)
                   for i in (F * 15, (F - 1) * 15, F * 48, (F - 1) * 48)) + \
        2.0 * B * (4 * d * 100 + 100 * 1)
    md2d_fwd = tower_fwd(B, F * 32, d, 1) + tower_fwd(B, (F - 1) * 2, d, 1) + \
        2.0 * B * (2 * d * 100 + 100 * 1)
    # video generator trunk: 128 -> d -> 3 res blocks -> F*35, on B rows
    gen_fwd = tower_fwd(B, 128, d, F * 35)

    per_update = 9.0
    critic_work = per_update * (2 * d3d_fwd + 2 * d2d_fwd + 4 * md3d_fwd + 4 * md2d_fwd)
    gen_synth = gen_fwd  # critic-phase fakes, no grad
    gen_update = (3.0 * gen_fwd + 2.0 * (d3d_fwd + d2d_fwd + md3d_fwd + md2d_fwd)) / 5.0
    return critic_work + gen_synth + gen_update


def gan_iter_flops(B: int, dense: int) -> float:
    """Analytic matmul-FLOP count of one single-frame GAN training
    iteration (critic updates with WGAN-GP every iteration + 1/5 of a
    generator update): a deliberate UNDERCOUNT (dense layers only; FK,
    projection and elementwise work ignored).

    ~9 fwd-equivalents a critic update, as :func:`video_iter_flops`; with
    flip every critic updates twice.  The generator trunk runs once for the
    critic-phase fakes (no grad) and, on every 5th iteration, fwd+bwd (3x)
    plus critic forwards for the adversarial scores."""
    def tower(in_dim, d, out_dim):
        return tower_fwd(B, in_dim, d, out_dim)

    gen_fwd = tower(128, dense, 35)
    d3d_fwd = tower(30, dense, 1) + tower(48, dense, 1) + \
        2.0 * B * (2 * dense * 100 + 100 * 1)   # KCS + pose branches + merge
    # the 2D critic is a 4-layer MLP with one residual hop (32->d, 4x dxd,
    # d->1), not a ResTower
    d2d_fwd = 2.0 * B * (32 * dense + 4 * dense * dense + dense * 1)

    critic_updates = 2 * 2  # 3D + 2D, each doubled by flip
    per_critic = 9.0 * (d3d_fwd + d2d_fwd) / 2.0  # average the two critics
    gen_synth = gen_fwd                       # critic-phase fakes, no grad
    gen_update = (3.0 * gen_fwd + 2.0 * (d3d_fwd + d2d_fwd)) / 5.0
    return critic_updates * per_critic + gen_synth + gen_update


def fk_iter_flops(poses: int) -> float:
    """B1/B2's hand count per GAN iteration at ``poses`` poses a batch: B1
    for the critic-phase fakes, and every 5th iteration B1 + B2 for the
    generator update."""
    return poses * (FWD_FLOP_PER_POSE + (FWD_FLOP_PER_POSE + BWD_FLOP_PER_POSE) / 5.0)


def gan_args(batch: int, dense: int, device: str, video: bool = False):
    """The training command's parsed flags for the measurement tools: batch
    ``batch``, every GAN net ``dense`` wide, on ``device`` (a device type);
    with ``video`` the video command (``--architecture 3,3``, playback on;
    ``scripts/bench_video_gan.py:40-43``)."""
    d = str(dense)
    argv = ["--batch_size", str(batch), "--Gen_DenseDim", d, "--Dis_DenseDim_3D", d,
            "--Dis_DenseDim_2D", d, "--device", device]
    if video:
        argv += ["--single_or_multi_train_mode", "multi", "--architecture", "3,3",
                 "--GAN_video_playback_input", "true", "--video_Dis_DenseDim_3D", d,
                 "--video_Dis_DenseDim_2D", d]
    return parse_aug_args(argv)


def _real(shape, rng: np.random.Generator, device) -> torch.Tensor:
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32) * 0.3, device=device)


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def count_steps(B: int, dense: int, device, video: bool = False, frames: int = 9) -> tuple:
    """(critics_step FLOPs, generator_step FLOPs) counted on ``device``
    for one step each of fresh nets at batch ``B`` (clips when ``video``)
    and width ``dense``, on seeded N(0, 0.3) poses seen through S1's first
    camera, the motion critics on."""
    device = torch.device(device)
    torch.manual_seed(0)
    args = gan_args(B, dense, device.type, video)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    rng = np.random.default_rng(0)
    quats, trans, intrs = camera_bank(["S1"])
    cam16 = tiled_cam16(intrs[0], quats[0], trans[0], B, device)
    if video:
        steps = build_video_gan(args, train_subject_list(args), frames, device)
        real3d, real2d = _real((B, frames, 16, 3), rng, device), _real((B, frames, 16, 2),
                                                                        rng, device)
        extra = (True,)
    else:
        steps = build_gan(args, train_subject_list(args), device)
        real3d, real2d = _real((B, 16, 3), rng, device), _real((B, 16, 2), rng, device)
        extra = ()
    out = {}
    critics = _counted(lambda: out.update(step=steps.critics_step(real3d, cam16, real2d, g,
                                                                  *extra)))
    cam_idx, bone_len = out["step"][:2]
    gen = _counted(lambda: steps.generator_step(bone_len, cam_idx, g, *extra))
    return critics, gen


def report(name: str, critics: float, gen: float, hand: float, fk: float, xla: float,
           ms_per_iter=None, device_name: str = "") -> dict:
    """One program's line: the counted GFLOP per iteration (critics + gen
    / 5) beside the hand count, B1/B2's hand count and XLA's count of the
    JAX steps; with a measured ``ms_per_iter``, the achieved TFLOP/s and
    ``mfu_counted`` against the H100's fp32 peak (67 TFLOP/s: TF32 is off,
    so the critics' GEMMs run fp32 SIMT)."""
    flops = critics + gen / 5.0
    out = {"program": name, "device": device_name,
           "critics_gflops": critics / 1e9, "gen_update_gflops": gen / 1e9,
           "counted_gflops_per_iter": flops / 1e9, "hand_gflops_per_iter": hand / 1e9,
           "fk_hand_gflops_per_iter_not_counted": fk / 1e9,
           "xla_gflops_per_iter_jax_steps": xla, "counted_over_hand": flops / hand,
           "counted_over_xla": flops / 1e9 / xla}
    if ms_per_iter:
        achieved = flops / (ms_per_iter / 1e3)
        out.update(measured_ms_per_iter=ms_per_iter, achieved_tflops=achieved / 1e12,
                   mfu_counted=achieved / PEAK_FP32_FLOP_S, peak="67 TFLOP/s fp32 (H100 SXM)")
    return out


def single_frame(B: int = 1024, dense: int = 1000, device="cuda", ms_per_iter=None) -> dict:
    """The single-frame iteration's counts at batch ``B``."""
    critics, gen = count_steps(B, dense, device)
    return report(f"single_frame_iter(B={B},D={dense})", critics, gen, gan_iter_flops(B, dense),
                  fk_iter_flops(B), XLA_GFLOPS_PER_GAN_ITER, ms_per_iter, device_name(device))


def video(B: int = 512, dense: int = 1000, device="cuda", ms_per_iter=None,
          frames: int = 9) -> dict:
    """The video iteration's counts at ``B`` clips of ``frames`` frames."""
    critics, gen = count_steps(B, dense, device, video=True, frames=frames)
    return report(f"video_iter(B={B},F={frames},D={dense})", critics, gen,
                  video_iter_flops(B, frames, dense), fk_iter_flops(B * frames),
                  XLA_GFLOPS_PER_VIDEO_ITER, ms_per_iter, device_name(device))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ms_single", type=float, default=None,
                    help="a measured single-frame ms/iter (dhaug_torch.bench's GAN line)")
    ap.add_argument("--ms_video", type=float, default=None,
                    help="a measured video ms/iter (dhaug_torch.bench_video_gan)")
    ap.add_argument("--skip_video", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    device = dhaug_torch.resolve_device(args.device)
    out = [single_frame(device=device, ms_per_iter=args.ms_single)]
    print(out[-1], flush=True)
    if not args.skip_video:
        out.append(video(device=device, ms_per_iter=args.ms_video))
        print(out[-1], flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
