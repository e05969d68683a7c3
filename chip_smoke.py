#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dhaug_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits non-zero:

1. device  -- the card's name, count and power limit (fails without a card);
2. build   -- builds the CUDA kernels from this checkout's sources with nvcc
              (one nvcc per source, in parallel) and prints ptxas'
              register/spill report;
3. kernels -- holds each kernel to its plain PyTorch version on the card:
              the FK kernels B1/B2 at B = 1024 (the training path's batch),
              1000, 1, 1027 (ragged), 8192 (the synthesis batch), 10000
              (the traditional augmenter's), video mode's clip batches
              4608, 13824 and 72 and on inputs 4 bytes past a 16-byte
              boundary, and times them at
              B = 1024, 4608 and 8192 as device time a launch (torch.profiler),
              loop of launches and host time a call, beside a launch floor
              (a one-element ``zero_()``); the trunk kernel B3 at D = 1000 and
              B = 8192 (the synthesis batch), 1000 and 1, and at D = 64,
              B = 64 (one tile) and D = 256, B = 333 (ragged, several
              tiles); times kernel, plain version and, for B3, a cuBLAS
              yardstick with CUDA events; profiles B3's 8 launches at
              B = 8192 and prints each layer's device time beside its own
              FLOP and byte bound;
4. main    -- runs ``dhaug_torch.run_fk_gan.main`` with the README's
              single-frame FK-GAN command at full width (generator and both
              critics 1000 wide, MLP posenet 1024 wide with 4 stages,
              batch 1024) for 3 epochs, with the launch counters set to 0
              just before and read just after, and checks its results and
              its checkpoints;
5. profile -- times GAN iterations at those shapes and reads the device's
              busy share and top kernels from torch.profiler;
6. synth   -- runs ``dhaug_torch.synthesize_dataset.main`` on the snapshot
              the main phase wrote (65536 poses in batches of 8192), with
              the counters set to 0 just before and read just after, checks
              the loaded weights, the launches and the npz (shapes, finite,
              bone lengths in the scaler range), and times the synthesis
              body at B = 8192;
7. posenets -- the main command with ``--posenet_name gcn`` and then
              ``videopose`` (4 stages), 2 epochs each: scores, launches of
              B1 and B2, checkpoints, epoch seconds;
8. augment -- 1 epoch of ``--data_enhancement_method normal`` (one B1
              launch at B = 10000) and 1 of ``NO_enhance`` (none);
9. baseline -- ``dhaug_torch.run_baseline`` (videopose, the synth phase's
              npz mixed into the real pairs, 2 epochs), then
              ``dhaug_torch.run_evaluate`` on its best checkpoint (its best
              H36M P1 within 0.05 mm), on the gcn run's best checkpoint and
              on a ``.pth.tar`` of it (the same scores), with 3DPW scoring
              of a seeded fake SMPL-24 npz;
10. video  -- the README's video-mode command (``mulit_farme_videopose
              --single_or_multi_train_mode multi --architecture 3,3
              --batch_size 512``, every net at full width) for 3 epochs:
              B1 at 4608 poses every GAN iteration, B1 + B2 every 5th, the
              motion critics from epoch 1, the posenet in epoch 2; then
              ``run_evaluate`` on its best checkpoint (its best H36M P1
              within 0.05 mm); then 2 epochs of ``mulit_farme_poseformer``
              (windowed evaluation) and ``run_evaluate`` on its checkpoint;
              each ``run_evaluate`` also scores the baseline phase's fake
              SMPL-24 npz on centre-frame windows (3DPW);
11. cli_extras -- the committed fixture's preflight report, and the main
              command on a millimetre copy of it, which must stop with
              ``DataValidationError`` before any kernel launch; the main
              command with ``--synthetic_data true --bf16_trunk true`` into
              a fresh directory for 2 epochs: the fixture the port writes
              there must equal the committed one, B1/B2 launch exactly as
              in the main phase, and its GAN iterations are profiled; the
              video command with ``--bf16_trunk true`` for 2 epochs (B1 21,
              B2 3), its iterations profiled; the main command with
              ``--ckpt_format orbax``, which must train the main phase's
              weights bit for bit and write a snapshot directory holding
              what the main phase's pickle holds, resumed from it for the
              last epoch onto the same weights; a 2-epoch mlp
              ``run_baseline`` with it and ``run_evaluate`` on its
              ``ckpt_best/`` (its best H36M P1 within 0.05 mm);
12. tools  -- the port's three tools, each on the card by default, with
              the counters set to 0 just before and read just after:
              ``visualize_fk --sweep 3`` (its PNG; the 8 swept poses in one
              B1 launch, held to the plain FK), ``make_fk_inspector`` (the
              page; its 4 goldens in one B1 launch, held to the plain FK)
              and 1 epoch each of ``profile_epoch`` and ``profile_epoch
              --video`` (each phase's seconds; B1 at 1024 poses 4 times,
              as the main phase's first epoch; B1 at 4608 poses 10 times
              and B2 once);
13. prepare -- the offline data-prep CLIs: (a) the H36M prep's 2D
              projection on the card at the processed release's size
              (~0.53 M world frames of synthetic FK poses: the release
              cannot be downloaded), held to the CPU's within 1e-3 px, its
              seconds, the compressed write's seconds and bytes, peak
              memory; (b) at the fixture's size: the committed 3D as a
              release-layout .mat tree through ``python -m
              dhaug_torch.prepare_data_h36m --from-source`` (or, without
              h5py, its refusal and the projection in this process), the
              committed 3DHP set as a SPIN npz through ``python -m
              dhaug_torch.prepare_data_3dhp`` (back within 1e-6), the
              preflight on the prepared root and 1 epoch of the README's
              single-frame command from it with ``--warmup -1``, so that
              the posenet trains and is scored in it (B1 4 at 1024 rows,
              B2 0);
14. bench  -- ``python -m dhaug_torch.bench`` at full width and full batch
              with short repeats (8 synthesis batches of 65536 a call, 2
              calls; 20 GAN iterations at 1024 in 1 epoch; 10 video
              iterations of 512 x 9 in 1 rep; each after a warm-up), with
              the counters set to 0 just before and read just after: its
              three lines parse, in the order video, GAN, synthesis, the
              last with exactly metric/value/unit/vs_baseline, every
              number positive; B1 100, B2 14 and B3 24 launches exactly;
              then B1 and B3 at B = 65536 against their plain versions,
              timed beside their bounds;
15. data_parallel -- ``--data_parallel_devices`` and multi-process
              synthesis on the one card: (a) the main command with
              ``--data_parallel_devices 2`` must stop before any launch;
              (b) the main command in an NCCL group of one rank must train
              the main phase's weights bit for bit; a full-width SGD
              witness: one critic phase and generator update of the
              single-frame (1024) and video (512 x 9) GANs and one MLP
              step (batch norm, dropout) on two gloo ranks sharing cuda:0
              against one rank running each GAN net's forward in two
              halves (the row counts a rank gives cuBLAS), each net's
              summed SGD steps within 2e-3 of its largest element, beside
              a control that must fail that bound (one rank's rows
              alone), the gaps to the plain one rank printed; (c) the
              main command cut to 2 epochs and (d) the video command cut
              to 1 epoch of a third of the clips (3 GAN iterations, the
              motion critics on, the posenet trained) on two gloo ranks
              sharing cuda:0 (``parallel/mesh.launch_main``; 512 and 2304
              poses a rank in B1/B2) against the same cut commands run on
              one rank first (``grid_references``): the first
              iteration's Wasserstein estimates within 1e-3 of the critic's
              scores, each rank's B1/B2 launches equal to the one-rank
              run's; the later iterations, the trained weights' gaps and
              the H36M P1 printed; (e)
              ``synthesize_dataset`` as two processes joined by
              ``--coordinator`` (B3 and B1 at 4096 rows a process): the npz
              must equal the two shards' streams run in this process.
              (c)-(e) sample the card's busy share with nvidia-smi; two
              ranks on one card compete for it, so their times are no
              scaling number;
16. tensor_parallel -- ``--model_parallel_devices`` on the one card: (a)
              the main command with ``--model_parallel_devices 2`` must
              stop before any launch; (b) the full-width SGD witness of
              data_parallel on a model group of two gloo ranks sharing
              cuda:0 (every wide layer's output columns split in two)
              against one rank computing each wide layer as two column
              blocks, each net's summed SGD steps within 2e-3 of its
              largest, beside a control that must fail that bound (the
              gather's backward summing the blocks instead of slicing),
              witness and control in one launch; (c) and (d) the cut main
              and video commands of data_parallel on the model group
              against the same one-rank runs: the first iteration's
              Wasserstein estimates within 1e-3 of the scores, each
              rank's B1/B2 launches equal to the one-rank run's; epoch
              seconds, collective share, weight gaps printed.

Each run of phases 7-10 (but the poseformer's) is then run once more under
torch.profiler, outside
the counted run, for its device kernel time, busy share and top kernels.
Each path's launch counters are set to 0 just before it runs and read just
after; a rank or process of phases 15-16 starts at 0 and reports its own.
Every JSON line but the last two carries ``t_s``, the script's seconds so
far.  Then it prints a ``done`` line with the script's seconds, the
``nvidia-smi`` name/power-limit line, one ``kernels`` JSON line, and last
``{"ok": true, "device": {...}}``.

Every training phase on the committed fixture passes the data preflight
(``data/validate.py``) first.  ``--record_all_picture`` is not driven: it
is host-only and needs matplotlib, which the card's machine may lack; the
CPU tests hold it.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
if (REPO / "dhaug_torch" / "__init__.py").is_file():  # else main() refuses with rc 2
    from dhaug_torch.ops.fk_cuda import BWD_FLOP_PER_POSE, FWD_FLOP_PER_POSE
    from dhaug_torch.utils.profiling import (PEAK_BF16_FLOP_S, bound_ms, cuda_time_ms,
                                             device_kernels, device_us, host_us, nvidia_smi,
                                             profile_iterations)

# Kernel vs plain version on the card.  Both run fp32 with the same
# formulas; they differ only in summation order, FMA contraction and the
# sin/cos implementation.  Measured on an H100: forward 2.4e-7 m, backward
# 1.9e-6 absolute on gradients up to ~13, so these leave a 4-5x margin.
FWD_ATOL = 1e-6      # metres
BWD_ATOL = 1e-5
BWD_RTOL = 1e-5

# FK kernel checks (batch, inputs 4 bytes past a 16-byte boundary) and the
# batches timed: the training path's 1024, a ragged last tile, the
# synthesis batch 8192, the traditional augmenter's 10000 (312 full tiles of
# 32 poses and one of 16), and video mode's clip batches B x F: 512 x 9
# (the README's --architecture 3,3 --batch_size 512), 512 x 27 (the default
# 3,3,3) and 8 x 9 (two full tiles and one of 8); and a rank's rows of two
# data-parallel ranks: 512 (training), 2304 (video clips), 4096 (synthesis)
FK_CHECKED = ((1024, False), (1000, False), (1, False), (1027, False), (8192, False),
              (1027, True), (10000, False), (4608, False), (13824, False), (72, False),
              (512, False), (2304, False), (4096, False))
FK_TIMED_B = (1024, 4608, 8192)

# the synthesis path: the generator width, the CLI's default batch, 8 batches
SYNTH_D = 1000
SYNTH_B = 8192
SYNTH_POSES = 8 * SYNTH_B
SCALER_RANGE = (0.8, 1.2)    # 1 + randint(-200, 200) / 1000
BONE_ATOL = 1e-5             # metres: fp32 camera coordinates reach ~20 m

# the JAX README's video-mode command, cut to 3 epochs: the motion critics
# from epoch 1, the posenet in epoch 2
VIDEO_ARGS = ["--note", "chip_smoke", "--posenet_name", "mulit_farme_videopose",
              "--single_or_multi_train_mode", "multi", "--architecture", "3,3",
              "--batch_size", "512", "--data_enhancement_method", "GAN", "--epochs", "2",
              "--warmup", "0", "--single_dis_warmup_epoch", "1", "--additional_train_epoch", "0",
              "--device", "cuda"]

# the prepare phase at the size of H36M's processed release (VideoPose3D's
# ~1.56 M training and ~0.54 M test camera frames over 4 cameras): world
# frames a subject; the card's 2D held to the CPU's (pixels reach ~1000 px,
# where a float32 ulp is ~6e-5)
PREP_WORLD_FRAMES = {"S1": 77988, "S5": 77988, "S6": 77988, "S7": 77988, "S8": 77988,
                     "S9": 67918, "S11": 67918}
PREP_PX_ATOL = 1e-3

MAIN_ARGS = ["--note", "chip_smoke", "--posenet_name", "mlp", "--lr_p", "1e-3",
             "--keypoints", "gt", "--batch_size", "1024",
             "--data_enhancement_method", "GAN", "--single_or_multi_train_mode", "single",
             "--epochs", "3", "--additional_train_epoch", "0", "--warmup", "0",
             "--device", "cuda"]


def with_flags(args: list, **flags) -> list:
    """``args`` with each ``--flag value`` of ``flags`` replaced or added."""
    out = list(args)
    for flag, value in flags.items():
        key = f"--{flag}"
        if key in out:
            out[out.index(key) + 1] = str(value)
        else:
            out += [key, str(value)]
    return out


STARTED = time.perf_counter()


def emit(obj) -> None:
    """``obj`` as one JSON line, with ``t_s``: the script's seconds so far."""
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - STARTED, 1)}), flush=True)


def fk_inputs(B: int, seed: int, device):
    """Angles uniform in +-120 deg, bone lengths in [0.1, 0.7] m, Euler
    rotation in +-180 deg, root ~ N(0, 1) (tests/test_fk_pallas.py:10-14)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-120, 120, (B, 33)), rng.uniform(0.1, 0.7, (B, 15)),
              rng.uniform(-180, 180, (B, 3)), rng.normal(size=(B, 3)),
              rng.normal(size=(B, 16, 3)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]


def misaligned(t):
    """A copy of ``t`` on the card whose data starts 4 bytes past a 16-byte
    boundary (the wrappers accept any 4-byte-aligned tensor)."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


def fk_bounds(B: int):
    """(bound ms, bound by) of B1 and B2 at batch B: each input read once,
    each output written once, against the fp32 FLOP counts above."""
    return (bound_ms(B * (33 + 15 + 3 + 3 + 48) * 4, B * FWD_FLOP_PER_POSE),
            bound_ms(B * (33 + 15 + 3 + 48 + 33 + 15 + 3 + 3) * 4, B * BWD_FLOP_PER_POSE))


def time_fk_kernels(fk_cuda, device) -> dict:
    """B1 and B2 at B = 1024, 4608 and 8192, three ways: device µs a launch
    (torch.profiler), the loop of launches (CUDA events over 200 calls,
    wrapper included) and host µs a call; the same for a launch floor, a
    one-element ``zero_()``."""
    import torch
    times = {}
    for B in FK_TIMED_B:
        ang, bl, grot, root, cot = fk_inputs(B, seed=7, device=device)
        for key, name, fn in (
                ("fwd", "fk_forward_kernel", lambda: fk_cuda.fk_forward_cuda(ang, bl, grot, root)),
                ("bwd", "fk_backward_kernel", lambda: fk_cuda.fk_backward_cuda(ang, bl, grot, cot))):
            times[f"{key}_device_us_{B}"] = device_us(fn, name)
            times[f"{key}_loop_ms_{B}"] = cuda_time_ms(fn)
            times[f"{key}_host_us_{B}"] = host_us(fn)
    one = torch.zeros(1, device=device)
    times["floor_device_us"] = device_us(one.zero_)
    times["floor_loop_ms"] = cuda_time_ms(one.zero_)
    times["floor_host_us"] = host_us(one.zero_)
    return times


def phase_kernels(fk_plain, fk_cuda, device):
    """Both kernels against the plain FK (forward) and autograd through it
    (backward) at the FK_CHECKED batches (ragged last tiles, video clip
    batches, inputs 4 bytes past a 16-byte boundary among them); then
    timings (time_fk_kernels) and the plain versions' at B = 1024."""
    import torch
    fwd_err, bwd_err = 0.0, 0.0
    for B, shift in FK_CHECKED:
        ang, bl, grot, root, cot = fk_inputs(B, seed=B, device=device)
        if shift:
            ang, bl, grot, root, cot = [misaligned(t) for t in (ang, bl, grot, root, cot)]
        got = fk_cuda.fk_forward_cuda(ang, bl, grot, root)
        inputs = [t.clone().requires_grad_(True) for t in (ang, bl, grot, root)]
        ref = fk_plain.fk_world_pose_16(*inputs)
        ref_grads = torch.autograd.grad(ref, inputs, cot)
        got_grads = fk_cuda.fk_backward_cuda(ang, bl, grot, cot)
        torch.cuda.synchronize()
        case = f"B={B}" + (" misaligned" if shift else "")
        err = float((got - ref.detach()).abs().max())
        if not err <= FWD_ATOL:
            raise AssertionError(f"forward kernel {case}: max abs err {err} m > {FWD_ATOL}")
        fwd_err = max(fwd_err, err)
        for name, r, g in zip(("dangles", "dbone_len", "dglobal_rot", "droot"),
                              ref_grads, got_grads):
            if not torch.allclose(g, r, atol=BWD_ATOL, rtol=BWD_RTOL):
                raise AssertionError(f"backward kernel {case} {name}: max abs err "
                                     f"{float((g - r).abs().max())} beyond atol {BWD_ATOL} "
                                     f"rtol {BWD_RTOL}")
            bwd_err = max(bwd_err, float((g - r).abs().max()))
        emit({"phase": "kernels", "B": B, "misaligned": shift, "fwd_max_abs_err_m": err,
              "bwd_max_abs_err": max(float((g - r).abs().max())
                                     for r, g in zip(ref_grads, got_grads))})

    times = time_fk_kernels(fk_cuda, device)
    B = 1024
    ang, bl, grot, root, cot = fk_inputs(B, seed=7, device=device)
    inputs = [t.clone().requires_grad_(True) for t in (ang, bl, grot, root)]
    plain_out = fk_plain.fk_world_pose_16(*inputs)
    with torch.no_grad():
        times["fwd_plain_ms"] = cuda_time_ms(lambda: fk_plain.fk_world_pose_16(ang, bl, grot, root))
    times["bwd_plain_ms"] = cuda_time_ms(
        lambda: torch.autograd.grad(plain_out, inputs, cot, retain_graph=True), iters=50)
    fwd_bound, bwd_bound = fk_bounds(B)
    emit({"phase": "kernels", "B": B, **times,
          "fwd_bound_ms": fwd_bound[0], "bwd_bound_ms": bwd_bound[0],
          "fwd_bound_ms_8192": fk_bounds(8192)[0][0], "bwd_bound_ms_8192": fk_bounds(8192)[1][0]})
    return fwd_err, bwd_err, times, fwd_bound, bwd_bound


def trunk_flops(B: int, D: int) -> float:
    """Multiply-adds x 2 of the trunk: 128 -> D, 6 x (D -> D), D -> 35."""
    return 2.0 * B * (128 * D + 6 * D * D + 35 * D)


def trunk_bytes(B: int, D: int) -> float:
    """Each input read once, the output written once: bf16 weights, fp32
    biases, fp32 noise and head."""
    weights = 128 * D + 6 * D * D + 35 * D
    return weights * 2 + (7 * D + 35) * 4 + B * 128 * 4 + B * 35 * 4


TRUNK_LAYERS = ("prelude", "a1", "b1", "a2", "b2", "a3", "b3", "head")


def trunk_layer_work(B: int, D: int) -> list:
    """(FLOP, bytes) of each of B3's 8 launches: each layer's own inputs
    read once and outputs written once, with the kernel's storage types
    (fp32 noise, h and head; bf16 weights, y and h's shadow; fp32 biases).
    The last layer b writes no fp32 h: only its shadow has a reader."""
    w_hidden = 2 * D * D + 4 * D
    work = [(2.0 * B * 128 * D, B * 128 * 4 + 2 * 128 * D + 4 * D + B * D * (4 + 2))]
    for blk in range(3):
        work.append((2.0 * B * D * D, 2 * B * D + w_hidden + 2 * B * D))
        h_out = 4 * B * D if blk < 2 else 0
        work.append((2.0 * B * D * D, 2 * B * D + 4 * B * D + w_hidden + h_out + 2 * B * D))
    work.append((2.0 * B * D * 35, 2 * B * D + 2 * 35 * D + 4 * 35 + 4 * B * 35))
    return work


def library_trunk(ops_bf16, noise):
    """The yardstick: the same 8 layers as cuBLAS bf16 ``torch.addmm``
    calls with fp32 ReLU and residual between them.  Its outputs and biases
    are bf16, so it is not the same function as B3; the port never calls
    it."""
    import torch
    w, b = ops_bf16[0::2], ops_bf16[1::2]
    h = torch.relu(torch.addmm(b[0], noise.to(torch.bfloat16), w[0].t()).float())
    for i in range(1, 7, 2):
        y = torch.relu(torch.addmm(b[i], h.to(torch.bfloat16), w[i].t()).float())
        h = torch.relu(torch.addmm(b[i + 1], y.to(torch.bfloat16), w[i + 1].t()).float() + h)
    return torch.addmm(b[7], h.to(torch.bfloat16), w[7].t()).float()


def trunk_operands(trunk_cuda, D: int, device):
    import torch
    from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
    torch.manual_seed(0)
    return trunk_cuda.trunk_weights(FkGeneratorNet(GeneratorConfig(dense_dim=D)).to(device))


def profile_trunk_layers(trunk_cuda, ops, noise, calls: int = 5) -> list:
    """Device time of each of B3's 8 launches at noise's batch, the median
    over ``calls`` profiled trunk calls after warm-up, beside the layer's
    own bound (torch.profiler's kernel events, in launch order)."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        trunk_cuda.trunk_forward_cuda(ops, noise)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            trunk_cuda.trunk_forward_cuda(ops, noise)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "trunk_gemm_kernel" in e.name), key=lambda e: e.time_range.start)
    n = len(TRUNK_LAYERS)
    if len(events) != n * calls:
        raise AssertionError(f"profiled {len(events)} trunk_gemm_kernel launches, "
                             f"expected {n * calls}")
    rows = []
    for i, ((flop, nbytes), name) in enumerate(zip(trunk_layer_work(noise.shape[0], SYNTH_D),
                                                   TRUNK_LAYERS)):
        us = statistics.median(events[c * n + i].time_range.elapsed_us() for c in range(calls))
        bound = bound_ms(nbytes, flop, PEAK_BF16_FLOP_S)
        rows.append({"layer": name, "device_us": us, "flop": flop, "bytes": nbytes,
                     "bound_us": bound[0] * 1e3, "bound_by": bound[1],
                     "tflop_per_s": flop / us / 1e6, "tb_per_s": nbytes / us / 1e6})
    return rows


def phase_trunk_kernel(trunk_cuda, device):
    """B3 against the plain bf16 trunk at D = 1000, B = 8192, 1000, 1 and
    4096 (a rank's rows of a 2-process synthesis) and at D = 64, B = 64 and
    D = 256, B = 333, to the rule of
    trunk_cuda.TRUNK_MAX_ERR / TRUNK_MEAN_ERR (max and mean absolute error
    over the std of the head); then timings and the per-layer profile at
    B = 8192."""
    import numpy as np
    import torch

    max_abs = 0.0
    for D, B in ((SYNTH_D, SYNTH_B), (SYNTH_D, 1000), (SYNTH_D, 1), (64, 64), (256, 333),
                 (SYNTH_D, SYNTH_B // 2)):
        case_ops = trunk_operands(trunk_cuda, D, device)
        noise = torch.as_tensor(np.random.default_rng(B).normal(size=(B, 128)),
                                dtype=torch.float32, device=device)
        got = trunk_cuda.trunk_forward_cuda(case_ops, noise)
        torch.cuda.synchronize()
        ref = trunk_cuda.trunk_reference_bf16(case_ops, noise)
        max_rel, mean_rel = trunk_cuda.trunk_errors(got, ref)
        err = float((got - ref).abs().max())
        emit({"phase": "kernels", "kernel": "trunk", "D": D, "B": B,
              "max_abs_err": err, "max_err_over_std": max_rel,
              "mean_err_over_std": mean_rel})
        if not (got.shape == (B, 35) and bool(torch.isfinite(got).all())
                and max_rel <= trunk_cuda.TRUNK_MAX_ERR
                and mean_rel <= trunk_cuda.TRUNK_MEAN_ERR):
            raise AssertionError(
                f"trunk kernel D={D} B={B}: shape {tuple(got.shape)}, max/std {max_rel} "
                f"(<= {trunk_cuda.TRUNK_MAX_ERR}), mean/std {mean_rel} "
                f"(<= {trunk_cuda.TRUNK_MEAN_ERR})")
        max_abs = max(max_abs, err)

    ops = trunk_operands(trunk_cuda, SYNTH_D, device)
    noise = torch.randn(SYNTH_B, 128, device=device)
    ops_bf16 = tuple(t.to(torch.bfloat16) for t in ops)
    times = {"ms": cuda_time_ms(lambda: trunk_cuda.trunk_forward_cuda(ops, noise), iters=100),
             "plain_ms": cuda_time_ms(lambda: trunk_cuda.trunk_reference_bf16(ops, noise),
                                      iters=20, warmup=5),
             "library_ms": cuda_time_ms(lambda: library_trunk(ops_bf16, noise), iters=100)}
    bound = bound_ms(trunk_bytes(SYNTH_B, SYNTH_D), trunk_flops(SYNTH_B, SYNTH_D),
                     PEAK_BF16_FLOP_S)
    emit({"phase": "kernels", "kernel": "trunk", "D": SYNTH_D, "B": SYNTH_B, **times,
          "library": "8 cuBLAS bf16 addmm calls, bf16 outputs, fp32 ReLU/residual "
                     "(not the same function)",
          "bound_ms": bound[0], "bound_by": bound[1],
          "tflop_per_s": trunk_flops(SYNTH_B, SYNTH_D) / times["ms"] / 1e9})
    layers = profile_trunk_layers(trunk_cuda, ops, noise)
    emit({"phase": "kernels", "kernel": "trunk", "D": SYNTH_D, "B": SYNTH_B,
          "profiled_device_us_sum": sum(r["device_us"] for r in layers), "layers": layers})
    return max_abs, times, bound


def reset_counts(fk_cuda, trunk_cuda) -> None:
    fk_cuda.FWD_LAUNCHES = 0
    fk_cuda.BWD_LAUNCHES = 0
    trunk_cuda.TRUNK_LAUNCHES = 0


def read_counts(fk_cuda, trunk_cuda) -> dict:
    return {"fwd": fk_cuda.FWD_LAUNCHES, "bwd": fk_cuda.BWD_LAUNCHES,
            "trunk": trunk_cuda.TRUNK_LAUNCHES}


def phase_main(fk_cuda, trunk_cuda, device):
    """The README's single-frame FK-GAN command, 3 epochs at full width."""
    import torch
    from dhaug_torch import run_fk_gan
    from dhaug_torch.ops.bones import bone_lengths_fk

    args = MAIN_ARGS + ["--data_root", str(REPO),
                        "--checkpoint", str(REPO / "_runs" / "chip_smoke")]
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts(fk_cuda, trunk_cuda)
    t0 = time.perf_counter()
    result = run_fk_gan.main(args)
    seconds = time.perf_counter() - t0
    launches = read_counts(fk_cuda, trunk_cuda)

    scores = result["scores"]
    metrics = {f"{s}_{k}": scores[s][k] for s in ("h36m", "dhp") for k in ("p1", "p2")}
    emit({"phase": "main", "seconds": seconds, "epoch_seconds": result["epoch_seconds"],
          "wasserstein": result["epoch_scalars"], "launches": launches, **metrics,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(device)})
    bad = {k: v for k, v in metrics.items() if not (math.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"main path metrics not finite and positive: {bad}")
    # 4 GAN iterations an epoch on the fixture's 4800 frames: 12 critic-phase
    # forwards, and generator updates at iterations 4 and 9
    if launches["fwd"] < 14 or launches["bwd"] < 2:
        raise AssertionError(f"main path did not run the kernels enough: {launches}")
    for k, v in result["epoch_scalars"].items():
        if not all(math.isfinite(x) for x in v):
            raise AssertionError(f"GAN scalar {k} not finite: {v}")
    # --snapshot 2 takes the full-state snapshot after epoch 1; the best
    # posenet saves follow the first evaluation
    run_dir = Path(result["run_dir"])
    for name in ("ckpt_resume_latest.ckpt", "ckpt_best_dhp_p1.ckpt", "ckpt_best_h36m_p1.ckpt"):
        if not (run_dir / name).is_file():
            raise AssertionError(f"main path wrote no {name} in {run_dir}")

    # bone-length canary on the trained generator: FK must reproduce the
    # (unscaled) bone lengths it was given
    gan = result["gan"]
    bl = torch.linspace(0.15, 0.6, 15, device=device).expand(256, 15).contiguous()
    with torch.no_grad():
        pose = gan.synth_fake(bl, None, scaler8=torch.zeros(256, 8, device=device))
    bl_err = float((bone_lengths_fk(pose) - bl).abs().max())
    if not (pose.shape == (256, 16, 3) and bl_err <= 1e-5):
        raise AssertionError(f"generated poses: shape {tuple(pose.shape)}, bone err {bl_err}")
    emit({"phase": "main", "bone_length_canary_max_err_m": bl_err,
          "checkpoints": sorted(p.name for p in run_dir.glob("ckpt_*"))})
    reference = {"nets": net_weights(result), "run_dir": run_dir, "launches": launches,
                 "scores": scores, "epoch_seconds": result["epoch_seconds"], "seconds": seconds}
    return launches, gan, run_dir, reference


def phase_profile(gan, device, iters: int = 10, label=None):
    """Where a GAN iteration's time goes at the main path's shapes (batch
    1024, nets 1000 wide), on its trained nets, outside the counted run
    (profile_iterations); ``label`` names a path other than the main one."""
    import torch
    from dhaug_torch.ops.camera import project_to_2d, world_to_camera_batch

    B, cam = 1024, 3
    g = torch.Generator(device=device)
    g.manual_seed(0)
    q, t, intr = gan.cam_quats[cam], gan.cam_trans[cam], gan.cam_intrs[cam]
    bl = torch.linspace(0.15, 0.6, 15, device=device).expand(B, 15).contiguous()
    with torch.no_grad():
        real = world_to_camera_batch(gan.synth_fake(bl, g), q[None], t[None])
        target_2d = project_to_2d(real, intr[None].expand(B, 9))
    cam16 = torch.cat([intr, q, t]).expand(B, 16).contiguous()

    def run(n):
        for it in range(n):
            cam_idx, bone_len, *_ = gan.critics_step(real, cam16, target_2d, g)
            if it % 5 == 4:
                gan.generator_step(bone_len, cam_idx, g)
        torch.cuda.synchronize()

    emit({"phase": "profile", **({"path": label} if label else {}),
          **profile_iterations(run, iters)})


def profile_video_iterations(gan, device, iters: int = 10, label: str = "video") -> None:
    """Video GAN iterations at the README command's shapes (512 clips of 9
    frames, every net 1000 wide), with the motion critics on and off, on
    the video run's trained nets, outside the counted run."""
    import torch
    from dhaug_torch.ops.camera import project_to_2d, world_to_camera_batch

    B, F, cam = 512, gan.gen_cfg.video_frames, 3
    g = torch.Generator(device=device)
    g.manual_seed(0)
    q, t, intr = gan.cam_quats[cam], gan.cam_trans[cam], gan.cam_intrs[cam]
    bl = torch.linspace(0.15, 0.6, 15, device=device).expand(B, 15).contiguous()
    with torch.no_grad():
        real = world_to_camera_batch(gan.synth_fake(bl, g).reshape(B * F, 16, 3), q[None],
                                     t[None])
        clip2d = project_to_2d(real, intr[None].expand(B * F, 9)).reshape(B, F, 16, 2)
    clip3d = real.reshape(B, F, 16, 3)
    cam16 = torch.cat([intr, q, t]).expand(B, 16).contiguous()
    for use_motion in (True, False):
        def run(n):
            for it in range(n):
                cam_idx, bone_len, *_ = gan.critics_step(clip3d, cam16, clip2d, g, use_motion)
                if it % 5 == 4:
                    gan.generator_step(bone_len, cam_idx, g, use_motion)
            torch.cuda.synchronize()
        emit({"phase": "profile", "path": label, "clips": B, "frames": F,
              "use_motion": use_motion, **profile_iterations(run, iters)})


def phase_synth(fk_cuda, trunk_cuda, run_dir: Path, device):
    """Bulk synthesis from the main phase's snapshot through the CLI, then
    the synthesis body alone at B = 8192."""
    import numpy as np
    import torch
    from dhaug_torch import synthesize_dataset
    from dhaug_torch.models.generator import GeneratorConfig
    from dhaug_torch.ops.bones import bone_lengths_fk
    from dhaug_torch.ops.fk import CANONICAL_BONE_LEN
    from dhaug_torch.parallel.sharded import make_sharded_synthesizer
    from dhaug_torch.utils.checkpoint import load_snapshot

    snapshot = run_dir / "ckpt_resume_latest.ckpt"
    out = REPO / "_runs" / "chip_smoke" / "dh_synth.npz"
    reset_counts(fk_cuda, trunk_cuda)
    result = synthesize_dataset.main([
        "--ckpt", str(snapshot), "--n_poses", str(SYNTH_POSES), "--batch", str(SYNTH_B),
        "--Gen_DenseDim", str(SYNTH_D), "--device", "cuda", "--out", str(out)])
    launches = read_counts(fk_cuda, trunk_cuda)
    n_batches = SYNTH_POSES // SYNTH_B
    if launches["trunk"] != n_batches or launches["fwd"] != n_batches:
        raise AssertionError(f"synthesis of {n_batches} batches launched {launches}")

    saved = load_snapshot(str(snapshot))["gen_state"]["model"]
    loaded = result["generator"].state_dict()
    if list(saved) != list(loaded) or not all(torch.equal(loaded[k].cpu(), v)
                                              for k, v in saved.items()):
        raise AssertionError("the synthesizer's generator differs from the snapshot's")

    data = np.load(out)
    shapes = {k: data[k].shape for k in ("pose3d", "pose2d", "cam")}
    if shapes != {"pose3d": (SYNTH_POSES, 16, 3), "pose2d": (SYNTH_POSES, 16, 2),
                  "cam": (SYNTH_POSES, 9)} or int(data["n_devices"]) != 1:
        raise AssertionError(f"npz shapes {shapes}, n_devices {data['n_devices']}")
    if not all(np.isfinite(data[k]).all() for k in shapes):
        raise AssertionError("npz holds non-finite values")
    # the camera is rigid: each bone keeps its scaled length, within
    # [0.8, 1.2) of the generator's input lengths; the thorax is never scaled
    lengths = bone_lengths_fk(torch.from_numpy(data["pose3d"]))
    bl = torch.tensor(CANONICAL_BONE_LEN, dtype=torch.float32)
    lo, hi = SCALER_RANGE
    below = float((lo * bl - lengths).max())
    above = float((lengths - hi * bl).max())
    thorax = float((lengths[:, 7] - bl[7]).abs().max())
    if below > BONE_ATOL or above >= 0 or thorax > BONE_ATOL:
        raise AssertionError(f"bone lengths outside the scaler range: {below} m below, "
                             f"{above} m above, thorax off by {thorax} m")

    # the body alone (noise -> B3 -> scalers -> B1) at B = 8192, and its parts
    synthesize = make_sharded_synthesizer(GeneratorConfig(dense_dim=SYNTH_D))
    ops = trunk_cuda.trunk_weights(result["generator"])
    bone_len = bl.to(device).expand(SYNTH_B, 15).contiguous()
    g = torch.Generator(device=device)
    g.manual_seed(0)
    body_ms = cuda_time_ms(lambda: synthesize(ops, bone_len, g), iters=50, warmup=5)
    noise = torch.randn(SYNTH_B, 128, device=device)
    trunk_ms = cuda_time_ms(lambda: trunk_cuda.trunk_forward_cuda(ops, noise), iters=50)
    ang, fbl, grot, root, _ = fk_inputs(SYNTH_B, seed=11, device=device)
    fk_ms = cuda_time_ms(lambda: fk_cuda.fk_forward_cuda(ang, fbl, grot, root), iters=50)
    emit({"phase": "synth", "launches": launches, "cli_poses": result["n_poses"],
          "cli_seconds": result["seconds"], "cli_poses_per_s": result["poses_per_s"],
          "body_ms_at_8192": body_ms, "body_poses_per_s": SYNTH_B / body_ms * 1e3,
          "trunk_ms_at_8192": trunk_ms, "fk_fwd_ms_at_8192": fk_ms,
          "trunk_share_of_body": trunk_ms / body_ms, "fk_share_of_body": fk_ms / body_ms,
          "bone_len_below_m": below, "bone_len_above_m": above, "thorax_err_m": thorax})
    return launches, {"cli_poses_per_s": result["poses_per_s"]}


def check_scores(label: str, scores: dict) -> dict:
    """H36M/3DHP P1 and P2 of a run, raising unless finite and positive."""
    metrics = {f"{s}_{k}": scores[s][k] for s in ("h36m", "dhp") for k in ("p1", "p2")}
    bad = {k: v for k, v in metrics.items() if not (math.isfinite(v) and v > 0)}
    if bad:
        raise AssertionError(f"{label}: metrics not finite and positive: {bad}")
    return metrics


def check_files(label: str, run_dir: Path, names) -> None:
    for name in names:
        if not (run_dir / name).is_file():
            raise AssertionError(f"{label} wrote no {name} in {run_dir}")


def profile_run(label: str, fn, wall_s: float) -> dict:
    """Run ``fn`` once more under torch.profiler and read its kernel time.
    Its busy share is that device time over ``wall_s``, the unprofiled
    run's wall seconds (the profiler slows the host); the top kernels come
    by device time, with their launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # device activity only: the kernel events are all this reads, and the
    # host events of a whole run take longer to gather than the run itself
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    out = {"path": label, "device_kernel_s": busy_s, "unprofiled_wall_s": wall_s,
           "device_busy_share": busy_s / wall_s,
           "top_kernels_device_s": [[e.key[:80], e.self_device_time_total / 1e6, e.count]
                                    for e in top]}
    emit({"phase": "profile", **out})
    return out


def phase_posenets(fk_cuda, trunk_cuda):
    """The README command with the gcn and then the videopose posenet, 2
    epochs each at full width (batch 1024, 4 stages): 8 GAN iterations, so
    one generator update (B2) and posenet passes on fakes and real data."""
    from dhaug_torch import run_fk_gan
    launches, run_dirs = {}, {}
    for name in ("gcn", "videopose"):
        args = with_flags(MAIN_ARGS, posenet_name=name, epochs=2, stages=4,
                          data_root=REPO, checkpoint=REPO / "_runs" / f"chip_smoke_{name}")
        reset_counts(fk_cuda, trunk_cuda)
        t0 = time.perf_counter()
        result = run_fk_gan.main(args)
        seconds = time.perf_counter() - t0
        launches[name] = read_counts(fk_cuda, trunk_cuda)
        metrics = check_scores(name, result["scores"])
        emit({"phase": "posenets", "posenet": name, "seconds": seconds,
              "epoch_seconds": result["epoch_seconds"], "launches": launches[name], **metrics})
        profile_run(name, lambda: run_fk_gan.main(args), seconds)
        # 8 critic-phase forwards and one generator update (iteration 4)
        if launches[name]["fwd"] < 9 or launches[name]["bwd"] < 1:
            raise AssertionError(f"{name}: the kernels ran too little: {launches[name]}")
        run_dirs[name] = Path(result["run_dir"])
        check_files(name, run_dirs[name], ("ckpt_resume_latest.ckpt", "ckpt_best_dhp_p1.ckpt",
                                           "ckpt_best_h36m_p1.ckpt"))
    return launches, run_dirs


def phase_augment(fk_cuda, trunk_cuda):
    """One epoch of --data_enhancement_method normal (10000 random FK poses:
    one B1 launch at B = 10000, seen through the 20 training cameras), then
    one of NO_enhance (no FK at all)."""
    from dhaug_torch import run_fk_gan
    launches = {}
    for method, want in (("normal", {"fwd": 1, "bwd": 0}), ("NO_enhance", {"fwd": 0, "bwd": 0})):
        args = with_flags(MAIN_ARGS, data_enhancement_method=method, epochs=1, data_root=REPO,
                          checkpoint=REPO / "_runs" / f"chip_smoke_{method}")
        reset_counts(fk_cuda, trunk_cuda)
        t0 = time.perf_counter()
        result = run_fk_gan.main(args)
        seconds = time.perf_counter() - t0
        launches[method] = read_counts(fk_cuda, trunk_cuda)
        metrics = check_scores(method, result["scores"])
        emit({"phase": "augment", "method": method, "seconds": seconds,
              "epoch_seconds": result["epoch_seconds"], "launches": launches[method],
              **metrics})
        profile_run(method, lambda: run_fk_gan.main(args), seconds)
        if {k: launches[method][k] for k in want} != want:
            raise AssertionError(f"{method}: launches {launches[method]}, expected {want}")
    return launches


def phase_baseline(fk_cuda, trunk_cuda, gcn_run_dir: Path):
    """run_baseline with videopose on the real data mixed with the synth
    phase's npz, 2 epochs; run_evaluate on its best checkpoint (the printed
    best H36M P1 within 0.05 mm), on the gcn run's best checkpoint
    ('model_pos' layout) and on a .pth.tar of that net, and 3DPW scoring of
    a seeded fake SMPL-24 npz."""
    import numpy as np
    import torch
    from dhaug_torch import run_baseline, run_evaluate
    from dhaug_torch.utils.checkpoint import load_ckpt

    runs = REPO / "_runs" / "chip_smoke"
    args = ["--posenet_name", "videopose", "--keypoints", "gt", "--batch_size", "1024",
            "--epochs", "2", "--train_npz", str(runs / "dh_synth.npz"), "--train_npz_mode", "mix",
            "--data_root", str(REPO), "--checkpoint", str(REPO / "_runs" / "chip_smoke_baseline"),
            "--device", "cuda"]
    reset_counts(fk_cuda, trunk_cuda)
    t0 = time.perf_counter()
    base = run_baseline.main(args)
    seconds = time.perf_counter() - t0
    launches = read_counts(fk_cuda, trunk_cuda)
    profile_run("baseline", lambda: run_baseline.main(args), seconds)
    base_dir = Path(base["run_dir"])
    check_files("run_baseline", base_dir, ("ckpt_best.ckpt", "ckpt_best_dhp_p1.ckpt"))
    common = ["--data_root", str(REPO), "--batch_size", "1024", "--device", "cuda"]
    ev = run_evaluate.main(["--evaluate", str(base_dir / "ckpt_best.ckpt")] + common)
    gap = abs(ev["h36m"]["p1"] - base["best_h36m"])
    if not (math.isfinite(base["best_h36m"]) and gap <= 0.05):
        raise AssertionError(f"evaluate gives H36M P1 {ev['h36m']['p1']}, the baseline's best "
                             f"was {base['best_h36m']}")

    gcn_ckpt = gcn_run_dir / "ckpt_best_h36m_p1.ckpt"
    ev_gcn = run_evaluate.main(["--evaluate", str(gcn_ckpt)] + common)
    pth = runs / "ckpt_gcn.pth.tar"
    torch.save({"model_pos": load_ckpt(str(gcn_ckpt))["model_pos"]}, pth)
    rng = np.random.default_rng(0)
    pw3d = runs / "fake_3dpw.npz"
    np.savez(pw3d, pose3d=rng.normal(size=(4096, 24, 3)).astype(np.float32) * 0.3,
             pose2d=rng.normal(size=(4096, 16, 2)).astype(np.float32) * 0.3)
    ev_pth = run_evaluate.main(["--evaluate", str(pth), "--posenet_name", "gcn",
                                "--Path_3DPW", str(pw3d)] + common)
    for label, scores in (("gcn .ckpt", ev_gcn), (".pth.tar", ev_pth)):
        check_scores(label, scores)
    pth_gap = max(abs(ev_gcn[s][k] - ev_pth[s][k]) for s in ("h36m", "dhp") for k in ("p1", "p2"))
    if not pth_gap <= 1e-3:
        raise AssertionError(f"the .pth.tar scores {ev_pth['h36m']}, {ev_pth['dhp']} differ from "
                             f"the .ckpt's {ev_gcn['h36m']}, {ev_gcn['dhp']}")
    if not all(math.isfinite(ev_pth["pw3d"][k]) for k in ("p1", "p2")):
        raise AssertionError(f"3DPW scores not finite: {ev_pth['pw3d']}")
    emit({"phase": "baseline", "seconds": seconds, "epoch_seconds": base["epoch_seconds"],
          "launches": launches,
          "best_h36m_p1": base["best_h36m"], "best_dhp_p1": base["best_dhp"],
          "evaluate_h36m_p1": ev["h36m"]["p1"], "evaluate_gap_mm": gap,
          "gcn_evaluate": {k: ev_gcn[k]["p1"] for k in ("h36m", "dhp")},
          "pth_tar_gap_mm": pth_gap, "pw3d": ev_pth["pw3d"]})
    return launches


def phase_video(fk_cuda, trunk_cuda):
    """The README's video-mode command (mulit_farme_videopose, batch 512,
    clips of 9 frames, every net at full width), 3 epochs: 27 GAN
    iterations on the fixture's 40 sequences (27 critic-phase B1 launches
    at 4608 poses) and generator updates at global iterations 4, 9, 14, 19,
    24 (B1 + B2 each); then run_evaluate on its best checkpoint (its best
    H36M P1 within 0.05 mm).  Then mulit_farme_poseformer for 2 epochs, the
    motion critics on from epoch 0: 18 iterations, 3 generator updates, and
    the windowed evaluation."""
    import torch
    from dhaug_torch import run_evaluate, run_fk_gan
    launches = {}
    for label, args, want in (
            ("video", VIDEO_ARGS, {"fwd": 27 + 5, "bwd": 5}),
            ("video_poseformer", with_flags(VIDEO_ARGS, posenet_name="mulit_farme_poseformer",
                                            single_dis_warmup_epoch=0),
             {"fwd": 18 + 3, "bwd": 3})):
        args = with_flags(args, data_root=REPO, checkpoint=REPO / "_runs" / f"chip_smoke_{label}")
        reset_counts(fk_cuda, trunk_cuda)
        t0 = time.perf_counter()
        result = run_fk_gan.main(args)
        seconds = time.perf_counter() - t0
        launches[label] = read_counts(fk_cuda, trunk_cuda)
        metrics = check_scores(label, result["scores"])
        scalars = result["epoch_scalars"]
        emit({"phase": "video", "path": label, "seconds": seconds,
              "epoch_seconds": result["epoch_seconds"], "launches": launches[label],
              "best_h36m_p1": result["best_h36m"], **metrics,
              "wasserstein": {k: v for k, v in scalars.items() if "Wasserstein" in k},
              "g_cost": scalars.get("G_cost")})
        if {k: launches[label][k] for k in want} != want:
            raise AssertionError(f"{label}: launches {launches[label]}, expected {want}")
        for k, v in scalars.items():
            if not all(math.isfinite(x) for x in v):
                raise AssertionError(f"{label}: GAN scalar {k} not finite: {v}")
        run_dir = Path(result["run_dir"])
        check_files(label, run_dir, ("ckpt_resume_latest.ckpt", "ckpt_best_dhp_p1.ckpt",
                                     "ckpt_best_h36m_p1.ckpt"))
        # 3DPW on the baseline phase's seeded fake SMPL-24 npz: centre-frame
        # windows of the flat sequence
        pw3d = REPO / "_runs" / "chip_smoke" / "fake_3dpw.npz"
        ev = run_evaluate.main(["--evaluate", str(run_dir / "ckpt_best_h36m_p1.ckpt"),
                                "--architecture", "3,3", "--batch_size", "512",
                                "--Path_3DPW", str(pw3d),
                                "--data_root", str(REPO), "--device", "cuda"])
        gap = abs(ev["h36m"]["p1"] - result["best_h36m"])
        emit({"phase": "video", "path": label, "evaluate_h36m_p1": ev["h36m"]["p1"],
              "evaluate_gap_mm": gap, "evaluate_dhp_p1": ev["dhp"]["p1"],
              "actions": len(ev.get("actions", {})), "pw3d": ev["pw3d"]})
        if not gap <= 0.05:
            raise AssertionError(f"{label}: evaluate gives H36M P1 {ev['h36m']['p1']}, the "
                                 f"run's best was {result['best_h36m']}")
        if not all(math.isfinite(ev["pw3d"][k]) and ev["pw3d"][k] > 0 for k in ("p1", "p2")):
            raise AssertionError(f"{label}: 3DPW scores not finite and positive: {ev['pw3d']}")
        if label == "video":
            profile_run(label, lambda: run_fk_gan.main(args), seconds)
            profile_video_iterations(result["gan"], torch.device("cuda", 0))
    return launches


# cli_extras (a): the written fixture against the committed one, per array
# (``data/synthetic.fixture_differences``): metres, pixels, metres and
# normalized screen units, metres
FIXTURE_TOL = {"data_3d_h36m.npz/positions_3d": 1e-5,
               "data_2d_h36m_gt.npz/positions_2d": 1e-2,
               "data_2d_h36m_cpn.npz/positions_2d": 1e-2,
               "test_3dhp.npz/pose3d": 1e-5, "test_3dhp.npz/pose2d": 1e-5,
               "hm36s15678_bl_templates.npy/lengths": 1e-6}


def preflight_refuses_mm_data(fk_cuda, trunk_cuda) -> None:
    """The committed fixture's preflight report, then the main command on a
    copy of it whose 3D file is in millimetres: it must stop with
    DataValidationError before any kernel launch."""
    import shutil
    import tempfile

    import numpy as np
    from dhaug_torch import run_fk_gan
    from dhaug_torch.data.validate import DataValidationError, validate_dataset_dir

    t0 = time.perf_counter()
    report = validate_dataset_dir(str(REPO), "gt", verbose=False)
    preflight_s = time.perf_counter() - t0
    (REPO / "_runs").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mm_", dir=REPO / "_runs"))
    try:
        for sub in ("data", "data_extra"):
            shutil.copytree(REPO / sub, root / sub)
        path = root / "data" / "data_3d_h36m.npz"
        d3 = np.load(path, allow_pickle=True)["positions_3d"].item()
        np.savez_compressed(path, positions_3d={s: {a: p * 1000.0 for a, p in acts.items()}
                                                for s, acts in d3.items()})
        reset_counts(fk_cuda, trunk_cuda)
        try:
            run_fk_gan.main(with_flags(MAIN_ARGS, data_root=root,
                                       checkpoint=REPO / "_runs" / "chip_smoke_mm"))
        except DataValidationError as exc:
            refusal = str(exc.code).strip().splitlines()
        else:
            raise AssertionError("the millimetre copy passed preflight")
        launches = read_counts(fk_cuda, trunk_cuda)
    finally:
        shutil.rmtree(root)
    if any(launches.values()) or "MILLIMETRES" not in " ".join(refusal):
        raise AssertionError(f"mm copy: launches {launches}, refusal {refusal}")
    emit({"phase": "cli_extras", "preflight_report": report, "preflight_s": preflight_s,
          "mm_refusal": refusal, "mm_launches": launches})


def phase_cli_extras(fk_cuda, trunk_cuda, device, main_ref: dict):
    """(d) preflight on the card's runs; (a) the README's single-frame
    command with --synthetic_data into a fresh directory (the fixture the
    port writes there must equal the committed one) and --bf16_trunk, 2
    epochs: 8 GAN iterations, so B1 8 + 1 and B2 1, as the main phase's
    first 2 epochs; its GAN iterations profiled; (b) the video command with
    --bf16_trunk, 2 epochs with the motion critics from epoch 0 (18
    iterations: B1 18 + 3, B2 3; the posenet trains in epoch 1), its
    iterations profiled."""
    import shutil
    import tempfile

    import torch
    from dhaug_torch import run_fk_gan
    from dhaug_torch.data.synthetic import fixture_differences

    preflight_refuses_mm_data(fk_cuda, trunk_cuda)
    launches = {}
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_synthetic_", dir=REPO / "_runs"))
    try:
        args = with_flags(MAIN_ARGS, epochs=2, synthetic_data="true", bf16_trunk="true",
                          data_root=root, checkpoint=REPO / "_runs" / "chip_smoke_bf16")
        reset_counts(fk_cuda, trunk_cuda)
        t0 = time.perf_counter()
        result = run_fk_gan.main(args)
        seconds = time.perf_counter() - t0
        launches["cli_extras_single"] = read_counts(fk_cuda, trunk_cuda)
        diffs = fixture_differences(str(root), str(REPO))
    finally:
        shutil.rmtree(root)
    metrics = check_scores("cli_extras_single", result["scores"])
    emit({"phase": "cli_extras", "path": "single_synthetic_bf16", "seconds": seconds,
          "epoch_seconds": result["epoch_seconds"],
          "launches": launches["cli_extras_single"], **metrics,
          "fixture_max_abs_diff": diffs, "wasserstein": result["epoch_scalars"]})
    bad = {k: v for k, v in diffs.items() if not v <= FIXTURE_TOL[k]}
    if bad:
        raise AssertionError(f"the fixture written on the card differs: {bad}")
    want = {"fwd": 8 + 1, "bwd": 1, "trunk": 0}
    if launches["cli_extras_single"] != want:
        raise AssertionError(f"bf16 single-frame: launches {launches['cli_extras_single']}, "
                             f"expected {want}")
    check_files("bf16 single-frame", Path(result["run_dir"]),
                ("ckpt_resume_latest.ckpt", "ckpt_best_dhp_p1.ckpt", "ckpt_best_h36m_p1.ckpt"))
    gen = result["gan"].gen
    if gen.dtype != torch.bfloat16 or any(p.dtype != torch.float32 for p in gen.parameters()):
        raise AssertionError("the bf16-trunk generator must compute in bf16 on fp32 weights")
    phase_profile(result["gan"], device, label="bf16_trunk")

    args = with_flags(VIDEO_ARGS, epochs=2, single_dis_warmup_epoch=0, bf16_trunk="true",
                      data_root=REPO, checkpoint=REPO / "_runs" / "chip_smoke_video_bf16")
    reset_counts(fk_cuda, trunk_cuda)
    t0 = time.perf_counter()
    result = run_fk_gan.main(args)
    seconds = time.perf_counter() - t0
    launches["cli_extras_video"] = read_counts(fk_cuda, trunk_cuda)
    metrics = check_scores("cli_extras_video", result["scores"])
    emit({"phase": "cli_extras", "path": "video_bf16", "seconds": seconds,
          "epoch_seconds": result["epoch_seconds"], "launches": launches["cli_extras_video"],
          **metrics, "best_h36m_p1": result["best_h36m"],
          "wasserstein": {k: v for k, v in result["epoch_scalars"].items()
                          if "Wasserstein" in k}})
    want = {"fwd": 18 + 3, "bwd": 3, "trunk": 0}
    if launches["cli_extras_video"] != want:
        raise AssertionError(f"bf16 video: launches {launches['cli_extras_video']}, "
                             f"expected {want}")
    for k, v in result["epoch_scalars"].items():
        if not all(math.isfinite(x) for x in v):
            raise AssertionError(f"bf16 video: GAN scalar {k} not finite: {v}")
    profile_video_iterations(result["gan"], device, label="video_bf16_trunk")
    launches.update(orbax_checks(fk_cuda, trunk_cuda, main_ref))
    return launches


class B1Rows:
    """Records the rows of every B1 launch made through
    ``fk_cuda.fk_forward_cuda`` inside the block (the launch and its count
    stay the wrapper's)."""

    def __init__(self, fk_cuda):
        self.fk_cuda, self.rows = fk_cuda, []

    def __enter__(self):
        launch = self.launch = self.fk_cuda.fk_forward_cuda

        def recording(angles, *rest):
            self.rows.append(int(angles.shape[0]))
            return launch(angles, *rest)
        self.fk_cuda.fk_forward_cuda = recording
        return self.rows

    def __exit__(self, *exc):
        self.fk_cuda.fk_forward_cuda = self.launch


def run_tool(fk_cuda, trunk_cuda, fn, argv):
    """``fn(argv)`` with the counters set to 0 just before and read just
    after: (result, seconds, launches, rows of each B1 launch)."""
    with B1Rows(fk_cuda) as rows:
        reset_counts(fk_cuda, trunk_cuda)
        t0 = time.perf_counter()
        result = fn(argv)
        seconds = time.perf_counter() - t0
        launches = read_counts(fk_cuda, trunk_cuda)
    return result, seconds, launches, sorted(set(rows))


def phase_tools(fk_cuda, trunk_cuda, device) -> dict:
    """The three tools through their ``main``, each on the card by default:
    (a) ``visualize_fk --sweep 3``: its PNG, one B1 launch for the 8 swept
    poses, within FWD_ATOL of the plain FK on the same inputs; (b)
    ``make_fk_inspector``: the page, its 16 scatter rows and its 4 goldens
    from one B1 launch within FWD_ATOL (plus the page's 6-decimal rounding)
    of the plain FK; (c) ``profile_epoch``, 1 epoch of the README's
    single-frame command: each phase's seconds, B1 at 1024 poses as in the
    main phase's first epoch (4 critic phases; its first generator update
    comes at global iteration 4, in epoch 1); (d) ``profile_epoch --video``,
    1 epoch of the video command with the motion critics on: 9 critic
    phases and the generator update at iteration 4, B1 at 512 x 9 = 4608
    poses, B2 once."""
    import re

    import numpy as np
    import torch
    from dhaug_torch import make_fk_inspector, profile_epoch, visualize_fk
    from dhaug_torch.ops import fk as fk_plain

    out_dir = REPO / "_runs" / "chip_smoke_tools"
    out_dir.mkdir(parents=True, exist_ok=True)
    launches = {}

    def plain_max_err(got, angles, bone_len, global_rot):
        rows = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).expand(
            len(angles), -1).contiguous()
        with torch.no_grad():
            want = fk_plain.fk_world_pose_16(rows(angles), rows(bone_len), rows(global_rot),
                                             torch.zeros(len(angles), 3, device=device))
        return float(np.abs(np.asarray(got) - want.cpu().numpy()).max())

    result, seconds, launches["visualize_fk"], rows = run_tool(
        fk_cuda, trunk_cuda, visualize_fk.main, ["--sweep", "3", "--out", str(out_dir / "knee.png")])
    png = Path(result["path"])
    err = plain_max_err(result["poses"], result["angles"], fk_plain.CANONICAL_BONE_LEN,
                        [0.0, 0.0, 0.0])
    emit({"phase": "tools", "tool": "visualize_fk", "seconds": seconds,
          "poses": len(result["angles"]), "sweep_range_deg": result["sweep_range"],
          "png_bytes": png.stat().st_size if png.is_file() else 0, "renderer": result["renderer"],
          "launches": launches["visualize_fk"], "b1_rows": rows, "max_abs_err_m": err})
    if not (png.is_file() and png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"):
        raise AssertionError(f"visualize_fk wrote no PNG at {png}")
    if launches["visualize_fk"] != {"fwd": 1, "bwd": 0, "trunk": 0} or not err <= FWD_ATOL:
        raise AssertionError(f"visualize_fk: launches {launches['visualize_fk']}, err {err}")

    result, seconds, launches["inspector"], rows = run_tool(
        fk_cuda, trunk_cuda, make_fk_inspector.main,
        ["--out", str(out_dir / "fk_inspector.html")])
    html = Path(result["path"]).read_text()
    spec = json.loads(re.search(r"const SPEC = (\{.*?\});\n", html, re.S).group(1))
    goldens = spec["goldens"]
    err = plain_max_err([g["pose"] for g in goldens], [g["angles"] for g in goldens],
                        [g["bone_len"] for g in goldens], [g["global_rot"] for g in goldens])
    emit({"phase": "tools", "tool": "make_fk_inspector", "seconds": seconds,
          "page_bytes": Path(result["path"]).stat().st_size, "goldens": len(goldens), "scatter16": len(spec["scatter16"]),
          "launches": launches["inspector"], "b1_rows": rows, "max_abs_err_m": err})
    if not ("<canvas" in html and "selfTest" in html and len(spec["scatter16"]) == 16
            and len(goldens) == 4):
        raise AssertionError("make_fk_inspector: the page lacks its viewer, scatter or goldens")
    if launches["inspector"] != {"fwd": 1, "bwd": 0, "trunk": 0} or \
            not err <= FWD_ATOL + 5e-7:
        raise AssertionError(f"make_fk_inspector: launches {launches['inspector']}, err {err}")

    for video, key, want, want_rows in (
            (False, "profile_epoch", {"fwd": 4, "bwd": 0, "trunk": 0}, [1024]),
            (True, "profile_epoch_video", {"fwd": 9 + 1, "bwd": 1, "trunk": 0}, [4608])):
        argv = ["--epochs", "1", "--data_root", str(REPO)] + (["--video"] if video else [])
        result, seconds, launches[key], rows = run_tool(fk_cuda, trunk_cuda,
                                                        profile_epoch.main, argv)
        phases = result["phases"]
        emit({"phase": "tools", "tool": key, "seconds": seconds,
              "phase_seconds": dict(phases), "launches": launches[key], "b1_rows": rows,
              "printed_launches": result["launches"]})
        names = [name for name, _ in phases]
        expected = ["video data prep", *profile_epoch.VIDEO_PHASES] if video else \
            ["data prep", *profile_epoch.SINGLE_FRAME_PHASES]
        if names != expected or not all(math.isfinite(t) and t >= 0 for _, t in phases):
            raise AssertionError(f"{key}: phases {phases}")
        if launches[key] != want or rows != want_rows or \
                result["launches"] != {k: want[k] for k in ("fwd", "bwd")}:
            raise AssertionError(f"{key}: launches {launches[key]} at rows {rows}, "
                                 f"expected {want} at {want_rows}")
    return launches


def prep_cli(module: str, argv: list, cwd: Path) -> subprocess.Popen:
    """``python -m <module> argv`` started in ``cwd`` (the prep CLIs write
    into their working directory)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cwd.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable, "-m", module, *argv], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: float = 300) -> tuple:
    """(returncode, stdout, stderr) of ``proc``, killed if it overruns."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, stdout, stderr


def release_sized_poses(device) -> dict:
    """Synthetic FK poses at the size of H36M's processed release: 7
    subjects, 30 sequences each (15 actions x 2 takes), PREP_WORLD_FRAMES
    world frames in all, drawn from a seed on the card."""
    import numpy as np
    from dhaug_torch.data.h36m import H36M_ACTIONS
    from dhaug_torch.data.synthetic import random_fk_poses

    rng = np.random.default_rng(0)
    names = [f"{a}{take}" for a in H36M_ACTIONS for take in ("", " 1")]
    return {s: dict(zip(names, np.array_split(random_fk_poses(rng, n, device), len(names))))
            for s, n in PREP_WORLD_FRAMES.items()}


def phase_prepare(fk_cuda, trunk_cuda, device) -> dict:
    """The offline data-prep CLIs. (a) The H36M prep's projection on the card
    at the processed release's size (synthetic FK poses: the release cannot
    be downloaded), held to the same function on the CPU within
    PREP_PX_ATOL, and the compressed write of both files. (b) At the
    fixture's size, end to end: the committed 3D as a release-layout .mat
    tree through ``python -m dhaug_torch.prepare_data_h36m --from-source``
    (or, where h5py does not import, that CLI's refusal naming h5py and the
    projection and write called in this process), the committed 3DHP set as
    a SPIN npz through ``python -m dhaug_torch.prepare_data_3dhp`` (back
    within 1e-6), the bone templates copied in, the preflight on the
    prepared root, and 1 epoch of the README's single-frame command from it
    with the posenet trained in it (B1 4 at 1024 rows, B2 0: the main
    command's first epoch), its H36M and 3DHP scores finite and positive."""
    import shutil

    import numpy as np
    import torch
    from dhaug_torch import prepare_data_3dhp, prepare_data_h36m, run_fk_gan, validate_data

    launches = {}
    out_dir = REPO / "_runs" / "chip_smoke_prepare"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)

    # (a) the release's size
    t0 = time.perf_counter()
    positions_3d = release_sized_poses(device)
    draw_s = time.perf_counter() - t0
    frames = sum(len(p) for acts in positions_3d.values() for p in acts.values())
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)   # what the earlier phases still hold
    reset_counts(fk_cuda, trunk_cuda)
    t0 = time.perf_counter()
    got = prepare_data_h36m.project_positions_2d(positions_3d, device)
    torch.cuda.synchronize(device)
    project_s = time.perf_counter() - t0
    launches["prepare_projection"] = read_counts(fk_cuda, trunk_cuda)
    peak = torch.cuda.max_memory_allocated(device) - held
    t0 = time.perf_counter()
    want = prepare_data_h36m.project_positions_2d(positions_3d, "cpu")
    cpu_s = time.perf_counter() - t0
    err = max(float(np.abs(g - w).max()) for s, acts in want.items() for a, cams in acts.items()
              for g, w in zip(got[s][a], cams))
    t0 = time.perf_counter()
    paths = prepare_data_h36m.write_outputs(positions_3d, got, str(out_dir))
    write_s = time.perf_counter() - t0
    written = {Path(p).name: Path(p).stat().st_size for p in paths}
    for p in paths:
        Path(p).unlink()
    emit({"phase": "prepare", "step": "release_size", "data": "synthetic FK poses at H36M's size",
          "subjects": len(positions_3d), "sequences": sum(map(len, positions_3d.values())),
          "world_frames": frames, "camera_frames": 4 * frames, "draw_s": draw_s,
          "projection_s": project_s, "world_frames_per_s": frames / project_s,
          "camera_frames_per_s": 4 * frames / project_s, "cpu_projection_s": cpu_s,
          "max_abs_err_px": err, "write_s": write_s, "written_bytes": written,
          "input_bytes_3d": frames * 32 * 3 * 4, "output_bytes_2d": frames * 4 * 16 * 2 * 4,
          "projection_peak_bytes": peak,
          "launches": launches["prepare_projection"]})
    if not err <= PREP_PX_ATOL or any(launches["prepare_projection"].values()):
        raise AssertionError(f"prepare: card vs CPU {err} px, launches "
                             f"{launches['prepare_projection']}")
    del positions_3d, got, want

    # (b) the fixture's size, end to end
    root = out_dir / "root"
    fixture_3d = np.load(REPO / "data" / "data_3d_h36m.npz",
                         allow_pickle=True)["positions_3d"].item()
    committed = np.load(REPO / "data_extra" / "test_set" / "test_3dhp.npz")
    names = [f"mpi_inf_3dhp_test_set/TS{1 + i % 6}/imageSequence/img_{i:06d}.jpg"
             for i in range(len(committed["pose3d"]))]
    np.savez(out_dir / "spin.npz", **prepare_data_3dhp.spin_layout(
        committed["pose3d"], committed["pose2d"], names))
    try:
        import h5py  # noqa: F401
        route = "from_source"
        prepare_data_h36m.write_mat_tree(fixture_3d, str(out_dir / "release"))
    except ImportError:
        route = "h5py_refused"
    t0 = time.perf_counter()
    procs = [prep_cli("dhaug_torch.prepare_data_h36m", ["--from-source", str(out_dir / "release")],
                      root / "data"),
             prep_cli("dhaug_torch.prepare_data_3dhp", ["--source", str(out_dir / "spin.npz")],
                      root / "data_extra")]
    (rc_h36m, out_h36m, err_h36m), (rc_3dhp, out_3dhp, err_3dhp) = map(finish, procs)
    cli_s = time.perf_counter() - t0
    if rc_3dhp != 0:
        raise AssertionError(f"prepare_data_3dhp failed ({rc_3dhp}): {err_3dhp[-3000:]}")
    if route == "from_source" and rc_h36m != 0:
        raise AssertionError(f"prepare_data_h36m failed ({rc_h36m}): {err_h36m[-3000:]}")
    if route == "h5py_refused":
        if rc_h36m == 0 or "h5py is required" not in err_h36m:
            raise AssertionError(f"no h5py, yet prepare_data_h36m gave rc {rc_h36m}: "
                                 f"{err_h36m[-3000:]}")
        prepare_data_h36m.write_outputs(
            fixture_3d, prepare_data_h36m.project_positions_2d(fixture_3d, device),
            str(root / "data"))
    prepared_3d = np.load(root / "data" / "data_3d_h36m.npz", allow_pickle=True)[
        "positions_3d"].item()
    err_3d = max(float(np.abs(prepared_3d[s][a] - p).max())
                 for s, acts in fixture_3d.items() for a, p in acts.items())
    prepared = np.load(root / "data_extra" / "test_set" / "test_3dhp.npz")
    err_3dhp = {k: float(np.abs(prepared[k] - committed[k]).max()) for k in ("pose3d", "pose2d")}
    emit({"phase": "prepare", "step": "fixture_clis", "route": route, "cli_s": cli_s,
          "h36m_rc": rc_h36m,
          "h36m_last_line": (out_h36m if rc_h36m == 0 else err_h36m).strip().splitlines()[-1],
          "max_abs_err_3d_m": err_3d, "3dhp_round_trip_max_abs": err_3dhp,
          "3dhp_last_line": out_3dhp.strip().splitlines()[-1]})
    if not err_3d <= 1e-7 or not max(err_3dhp.values()) <= 1e-6:
        raise AssertionError(f"prepared files differ: 3D {err_3d}, 3DHP {err_3dhp}")

    shutil.copytree(REPO / "data_extra" / "bone_length_npy",
                    root / "data_extra" / "bone_length_npy")
    report = validate_data.main(["--data_root", str(root)])
    with B1Rows(fk_cuda) as rows:
        reset_counts(fk_cuda, trunk_cuda)
        t0 = time.perf_counter()
        # --warmup -1: the posenet trains in that one epoch (it trains in
        # epochs after --warmup), as profile_epoch's epoch does
        result = run_fk_gan.main(with_flags(MAIN_ARGS, epochs=1, warmup=-1, data_root=root,
                                            checkpoint=out_dir / "run"))
        seconds = time.perf_counter() - t0
        launches["prepare"] = read_counts(fk_cuda, trunk_cuda)
    metrics = check_scores("prepare", result["scores"])
    emit({"phase": "prepare", "step": "epoch", "preflight_report": report, "seconds": seconds,
          "epoch_seconds": result["epoch_seconds"], "launches": launches["prepare"],
          "b1_rows": sorted(set(rows)), **metrics})
    if launches["prepare"] != {"fwd": 4, "bwd": 0, "trunk": 0} or sorted(set(rows)) != [1024]:
        raise AssertionError(f"prepare epoch: launches {launches['prepare']} at rows {rows}")
    return launches


# The bench phase: ``python -m dhaug_torch.bench`` at full width and full
# batch with short repeats, and B1/B3 at the synthesis line's batch.
BENCH_ARGV = ["--scan_steps", "8", "--iters", "2", "--gan_scan", "20", "--gan_iters", "1",
              "--video_batches", "10", "--video_reps", "1", "--baseline_iters", "5"]
BENCH_B = 65536


def bench_launches(scan_steps=8, iters=2, gan_scan=20, gan_iters=1, video_batches=10,
                   video_reps=1) -> dict:
    """The kernel launches BENCH_ARGV implies: the synthesis line's
    (1 warm-up + iters) calls of scan_steps batches each make one B3 and
    one B1 launch a batch; the GAN line's (1 + gan_iters) epochs of
    gan_scan iterations make one B1 launch an iteration and, on every
    iteration i with i % 5 == 4 (the count runs on across epochs), one more
    B1 and one B2 for the generator update; the video line's
    (1 + video_reps) epochs of video_batches iterations likewise; and each
    training line's FLOP count runs one critics_step (B1) and one
    generator_step (B1, B2)."""
    synth = (1 + iters) * scan_steps
    n_gan, n_video = (1 + gan_iters) * gan_scan, (1 + video_reps) * video_batches
    gen = sum(1 for i in range(n_gan) if i % 5 == 4) + \
        sum(1 for i in range(n_video) if i % 5 == 4)
    return {"fwd": synth + n_gan + n_video + gen + 2 * 2, "bwd": gen + 2, "trunk": synth}


def phase_bench(fk_cuda, trunk_cuda, device) -> dict:
    """``python -m dhaug_torch.bench`` (in this process, so its launches
    count) at full width and full batch with short repeats (BENCH_ARGV):
    its three JSON lines parse, come in the order video, GAN, synthesis,
    the last holds exactly metric, value, unit and vs_baseline, every
    number in them is positive, the lines before it name this card; the
    B1/B2/B3 launches equal bench_launches() -- B1 96 + 4, B2 12 + 2, B3
    24 -- at 1024, 4608 and 65536 rows.  Then B1 and B3 at the synthesis
    line's batch of 65536 rows against their plain versions (B1 within
    FWD_ATOL; B3 to trunk_cuda's rule over the head's std), timed beside
    their bounds and plain versions (and B3 beside the cuBLAS yardstick
    of the kernels phase)."""
    import contextlib
    import io

    import numpy as np
    import torch
    from dhaug_torch import bench

    out = io.StringIO()
    with B1Rows(fk_cuda) as rows, contextlib.redirect_stdout(out):
        reset_counts(fk_cuda, trunk_cuda)
        t0 = time.perf_counter()
        bench.main(BENCH_ARGV)
        seconds = time.perf_counter() - t0
        launches = read_counts(fk_cuda, trunk_cuda)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    emit({"phase": "bench", "seconds": seconds, "launches": launches,
          "b1_rows": sorted(set(rows)), "lines": lines})
    kind = torch.cuda.get_device_name(device)
    positive = lambda line: all(v > 0 for v in line.values()
                                if isinstance(v, (int, float)) and not isinstance(v, bool))
    problems = []
    if [line.get("metric", "").split(" ")[0] for line in lines] != ["video", "GAN", "augmented"]:
        problems.append(f"lines out of order: {[line.get('metric') for line in lines]}")
    elif set(lines[-1]) != {"metric", "value", "unit", "vs_baseline"}:
        problems.append(f"last line keys {sorted(lines[-1])}")
    if not all(positive(line) for line in lines):
        problems.append("a number not positive")
    if not all(line.get("device", {}).get("name") == kind for line in lines[:-1]):
        problems.append("a line does not name the card")
    if launches != bench_launches() or sorted(set(rows)) != [1024, 4608, BENCH_B]:
        problems.append(f"launches {launches} at rows {sorted(set(rows))}, expected "
                        f"{bench_launches()} at [1024, 4608, {BENCH_B}]")
    if problems:
        raise AssertionError(f"bench: {problems}")

    # B1 and B3 at the synthesis line's batch
    from dhaug_torch.ops import fk as fk_plain
    ang, bl, grot, root, _ = fk_inputs(BENCH_B, seed=BENCH_B, device=device)
    got = fk_cuda.fk_forward_cuda(ang, bl, grot, root)
    fwd_err = float((got - fk_plain.fk_world_pose_16(ang, bl, grot, root)).abs().max())
    ops = trunk_operands(trunk_cuda, SYNTH_D, device)
    noise = torch.as_tensor(np.random.default_rng(BENCH_B).normal(size=(BENCH_B, 128)),
                            dtype=torch.float32, device=device)
    ops_bf16 = tuple(t.to(torch.bfloat16) for t in ops)
    head = trunk_cuda.trunk_forward_cuda(ops, noise)
    ref = trunk_cuda.trunk_reference_bf16(ops, noise)
    max_rel, mean_rel = trunk_cuda.trunk_errors(head, ref)
    fwd_bound = fk_bounds(BENCH_B)[0]
    trunk_bound = bound_ms(trunk_bytes(BENCH_B, SYNTH_D), trunk_flops(BENCH_B, SYNTH_D),
                           PEAK_BF16_FLOP_S)
    with torch.no_grad():
        times = {
            "fwd_ms": cuda_time_ms(lambda: fk_cuda.fk_forward_cuda(ang, bl, grot, root),
                                   iters=50),
            "fwd_plain_ms": cuda_time_ms(lambda: fk_plain.fk_world_pose_16(ang, bl, grot, root),
                                         iters=10, warmup=3),
            "trunk_ms": cuda_time_ms(lambda: trunk_cuda.trunk_forward_cuda(ops, noise), iters=20),
            "trunk_plain_ms": cuda_time_ms(lambda: trunk_cuda.trunk_reference_bf16(ops, noise),
                                           iters=5, warmup=2),
            "trunk_library_ms": cuda_time_ms(lambda: library_trunk(ops_bf16, noise), iters=20)}
    emit({"phase": "bench", "B": BENCH_B, "fwd_max_abs_err_m": fwd_err,
          "trunk_max_abs_err": float((head - ref).abs().max()), "trunk_max_err_over_std": max_rel,
          "trunk_mean_err_over_std": mean_rel, **times, "fwd_bound_ms": fwd_bound[0],
          "fwd_bound_by": fwd_bound[1], "trunk_bound_ms": trunk_bound[0],
          "trunk_bound_by": trunk_bound[1]})
    if not (fwd_err <= FWD_ATOL and head.shape == (BENCH_B, 35)
            and bool(torch.isfinite(head).all()) and max_rel <= trunk_cuda.TRUNK_MAX_ERR
            and mean_rel <= trunk_cuda.TRUNK_MEAN_ERR):
        raise AssertionError(f"B = {BENCH_B}: B1 err {fwd_err} m (<= {FWD_ATOL}), B3 max/std "
                             f"{max_rel} (<= {trunk_cuda.TRUNK_MAX_ERR}), mean/std {mean_rel} "
                             f"(<= {trunk_cuda.TRUNK_MEAN_ERR})")
    return {"bench": launches}


def same_tree(a, b) -> bool:
    """Equal trees: the same containers and keys, tensors equal in dtype
    and bits, every other leaf of the same type and value."""
    import torch
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(same_tree(a[k], b[k])
                                                                 for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same_tree, a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return type(a) is type(b) and a == b


def orbax_checks(fk_cuda, trunk_cuda, main_ref: dict) -> dict:
    """``--ckpt_format orbax``: the main command with it must train the
    main phase's weights bit for bit and write, after epoch 1, a
    ``ckpt_resume_latest/`` directory holding what the main phase's pickle
    snapshot holds; resumed from the directory for the one epoch left, it
    must end on the main phase's weights bit for bit.  Then 2 epochs of
    ``run_baseline`` (mlp) with it, and ``run_evaluate`` on its
    ``ckpt_best/`` directory within 0.05 mm of the run's best H36M P1."""
    import torch
    from dhaug_torch import run_baseline, run_evaluate, run_fk_gan
    from dhaug_torch.utils.checkpoint import load_snapshot

    launches = {}
    differ = lambda got: [f"{name}.{k}" for name, ref in main_ref["nets"].items()
                          for kind in ("params", "buffers") for k, v in ref[kind].items()
                          if not torch.equal(got[name][kind][k], v)]
    args = with_flags(MAIN_ARGS, ckpt_format="orbax", data_root=REPO,
                      checkpoint=REPO / "_runs" / "chip_smoke_orbax")
    reset_counts(fk_cuda, trunk_cuda)
    t0 = time.perf_counter()
    result = run_fk_gan.main(args)
    seconds = time.perf_counter() - t0
    launches["cli_extras_orbax"] = read_counts(fk_cuda, trunk_cuda)
    snapshot = Path(result["run_dir"]) / "ckpt_resume_latest"
    trained = differ(net_weights(result))
    same = same_tree(load_snapshot(str(snapshot)),
                     load_snapshot(str(main_ref["run_dir"] / "ckpt_resume_latest.ckpt")))
    reset_counts(fk_cuda, trunk_cuda)
    resumed = run_fk_gan.main(args + ["--resume", str(snapshot), "--checkpoint",
                                      str(REPO / "_runs" / "chip_smoke_orbax_resumed")])
    launches["cli_extras_orbax_resumed"] = read_counts(fk_cuda, trunk_cuda)
    after_resume = differ(net_weights(resumed))

    base = ["--posenet_name", "mlp", "--epochs", "2", "--data_root", str(REPO),
            "--ckpt_format", "orbax"]
    reset_counts(fk_cuda, trunk_cuda)
    baseline = run_baseline.main(base + ["--checkpoint",
                                         str(REPO / "_runs" / "chip_smoke_orbax_baseline")])
    best_dir = Path(baseline["run_dir"]) / "ckpt_best"
    scored = run_evaluate.main(["--posenet_name", "mlp", "--data_root", str(REPO),
                                "--evaluate", str(best_dir)])
    launches["cli_extras_orbax_baseline"] = read_counts(fk_cuda, trunk_cuda)
    p1_gap = abs(scored["h36m"]["p1"] - baseline["best_h36m"])
    emit({"phase": "cli_extras", "path": "orbax", "seconds": seconds,
          "epoch_seconds": result["epoch_seconds"],
          "snapshot_files": sorted(p.name for p in snapshot.iterdir()),
          "arrays": len(list((snapshot / "arrays").iterdir())),
          "tensors_differing_from_main": trained, "snapshot_equals_main_pickle": same,
          "resumed_epoch_seconds": resumed["epoch_seconds"],
          "tensors_differing_after_resume": after_resume,
          "baseline_best_h36m_p1": baseline["best_h36m"],
          "evaluate_h36m_p1": scored["h36m"]["p1"], "p1_gap_mm": p1_gap,
          "launches": {k: launches[k] for k in launches}})
    if trained or not same or after_resume or len(resumed["epoch_seconds"]) != 1:
        raise AssertionError(f"orbax: {len(trained)} tensors differ from the main run, "
                             f"snapshot equal {same}, {len(after_resume)} differ after resume "
                             f"({after_resume[:5]})")
    if launches["cli_extras_orbax"] != main_ref["launches"]:
        raise AssertionError(f"orbax: launches {launches['cli_extras_orbax']}, main "
                             f"{main_ref['launches']}")
    if not p1_gap <= 0.05:
        raise AssertionError(f"orbax: run_evaluate on {best_dir} gives H36M P1 "
                             f"{scored['h36m']['p1']}, the run's best {baseline['best_h36m']}")
    return launches


# data_parallel: two gloo ranks sharing the one card against one rank.
#
# The update arithmetic is held first, at full width, by a witness that can
# fail: one critic phase and one generator update of the single-frame GAN
# (batch 1024) and of the video GAN (512 clips of 9 frames, motion critics
# on), and one step of the main command's MLP (1024 wide, 4 stages, batch
# norm and dropout), each with SGD at the CPU tests' rates and every draw
# injected at the global batch, on two gloo ranks sharing cuda:0 against
# one rank.  SGD keeps each update proportional to the gradient, so a
# missing or wrong all-reduce, or batch norm over a rank's rows, changes
# it by a share of its size; Adam, whose steps are ~lr whatever the
# gradient, cannot show that.
#
# The reference is one rank whose GAN nets run each forward in two halves
# of its batch (HalvesForward): the row counts a rank gives cuBLAS.  On the
# card cuBLAS picks other kernels for half the rows, and that alone moves
# the video 3D critic's penalty by 2.4e-2 of itself and so its SGD step
# by 9e-2 of its largest element (measured on an H100 80GB HBM3 at 700 W:
# the plain one-rank run read the same gaps against this reference as two
# ranks did against the plain run); each row's forward does not depend on
# the other rows, so against the halves reference the ranks differ only
# in how the per-row terms are summed.  Each net's summed SGD steps must
# agree to DP_UPDATE_TOL of the net's largest step element, the batch-norm
# statistics to 1e-6 and the critic phases' scalars to DP_METRIC_TOL (the
# tests' 1e-4) of the larger of the value, the critic's mean scores and 1.
# Measured on that card: at most 2.4e-4 (the generator), 8.6e-6 and
# 2.4e-7; the bound sits between 2.4e-4 and the control's least, 1.9e-2.
# The CPU tests' absolute weight bounds (critics 1e-6, generator 1e-5) are
# printed, not held: at full width the motion-3D critic's step reaches
# 1.1e-2 (penalty gradients ~1e5 at lr 1e-7) and its weights came 1.1e-6
# apart, 1.0e-4 of that step.  The gaps to the plain one-rank run are
# printed.  A control shows the bound can fail: one rank's rows alone in
# this process (what a rank computes with no all-reduce and no global
# batch norm) must be further than DP_UPDATE_TOL on every net.
#
# Then the main and video commands themselves run on two ranks, cut in
# depth (GRID_MAIN_ARGS, GRID_VIDEO_ARGS), against the same commands run
# on one rank here (grid_references): each rank must launch B1/B2 as the
# one-rank run does, and the first iteration's estimates keep
# DP_WASSERSTEIN_TOL (the tests' 1e-4 is too tight on the card: the video
# command's 3D estimate came 1.6e-4 apart, from the kernels cuBLAS picks
# for half the rows, which the witness's halves reference shows moving
# the same critic's penalty by 2.4e-2).  From the first Adam update on,
# the runs drift apart (Adam moves a weight ~lr a step even where its
# gradient is rounding noise), so the later iterations, the trained
# weights and H36M P1 are printed, not held.
DP_DEVICES = ["cuda:0", "cuda:0"]
DP_WASSERSTEIN_TOL = 1e-3
DP_UPDATE_TOL = 2e-3
DP_METRIC_TOL = 1e-4
DP_SUBJECTS = ["S1", "S5", "S6", "S7", "S8"]
DP_WIDTH = 1000
DP_SGD_LR = {"gen": 1e-2, "d3d": 1e-6, "d2d": 1e-6,                     # tests/test_torch_gan.py
             "v_gen": 1e-3, "v_d3d": 1e-7, "v_d2d": 1e-6, "v_md3d": 1e-7,  # tests/test_torch_video.py
             "v_md2d": 1e-6, "posenet": 1e-3}

# The commands of the grid runs (data_parallel and tensor_parallel (c)-(d)),
# cut in depth, not width: on gloo every gathered or reduced activation
# crosses host memory, which made a model group's GAN iteration take
# 13-26 s at 4608 rows and the two phases ~510 s of the script (an H100
# 80GB HBM3 at 700 W).  The main command runs 2 epochs (8 GAN iterations,
# the generator update at the 5th, the posenet in epoch 1); the video
# command 1 epoch of a third of the clips (--downsample 3: 3 GAN
# iterations with the motion critics on; video mode runs --epochs +
# --warmup + --single_dis_warmup_epoch epochs, so 2 - 1 + 0, and trains
# and scores the posenet in every epoch past --warmup + that warm-up).
# The video generator update on both grids is the SGD witnesses'.  (A
# fifth of the clips, one iteration, failed DP_WASSERSTEIN_TOL on the two
# data ranks: a motion critic's first-iteration estimate is the mean of
# its four sub-steps, three of them after Adam updates, and its clips
# put it 5.3e-3 apart, against 4.2e-4 at most here.)
GRID_MAIN_ARGS = with_flags(MAIN_ARGS, epochs=2, data_root=REPO)
GRID_VIDEO_ARGS = with_flags(VIDEO_ARGS, epochs=2, warmup=-1, single_dis_warmup_epoch=0,
                             downsample=3, data_root=REPO)


def grid_references(fk_cuda, trunk_cuda) -> tuple:
    """GRID_MAIN_ARGS and GRID_VIDEO_ARGS on one rank in this process: the
    references of the grid runs, and their launches."""
    refs = {}
    for name, args in (("main", GRID_MAIN_ARGS), ("video", GRID_VIDEO_ARGS)):
        refs[name] = one_rank_run(fk_cuda, trunk_cuda, args + [
            "--checkpoint", str(REPO / "_runs" / f"chip_smoke_grid_{name}_one_rank")])
        check_scores(f"grid_{name}_one_rank", refs[name]["scores"])
        emit({"phase": "grid_references", "path": name, "seconds": refs[name]["seconds"],
              "epoch_seconds": refs[name]["epoch_seconds"], "launches": refs[name]["launches"]})
    return refs, {f"grid_{name}_one_rank": ref["launches"] for name, ref in refs.items()}


def dp_witness_inputs(seed: int = 0, B: int = 1024, Bv: int = 512) -> dict:
    """The witness's global inputs and draws, numpy, from ``seed``: real
    poses from the plain FK at random angles 5 m before the camera, camera
    records of DP_SUBJECTS' bank, 2D targets, noise, scalers, camera
    indices and the GP alphas."""
    import numpy as np
    import torch
    from dhaug_torch.gan.wgan import camera_bank
    from dhaug_torch.ops import fk as fk_plain

    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)

    def poses(n):
        return fk_plain.fk_world_pose_16(*(torch.as_tensor(a, dtype=torch.float32) for a in (
            rng.uniform(-30, 30, (n, 33)),
            np.asarray(fk_plain.CANONICAL_BONE_LEN) * rng.uniform(0.9, 1.1, (n, 15)),
            rng.uniform(-30, 30, (n, 3)), np.broadcast_to([0.0, 0.0, 5.0], (n, 3))))).numpy()

    quats, trans, intrs = (np.asarray(x) for x in camera_bank(DP_SUBJECTS))
    bank = np.concatenate([intrs, quats, trans], 1)      # cam16 rows: intrinsics|quat|t

    def draws(B, F):
        # GP rows: the single-frame critics' and the per-frame motion-2D
        # critic's B x F, the motion-3D critic's B (tests/test_torch_video.py)
        rows = [B] * 4 if F == 1 else [B * F, B, B, B * F, B, B] + [B * F] * 6
        return dict(noise=f32(rng.normal(size=(B, 128))),
                    scaler8=f32(rng.integers(-200, 200, (B, 8)) / 1000.0),
                    cam_idx=int(rng.integers(0, len(bank))),
                    alphas=[f32(rng.uniform(size=(n, 1))) for n in rows])

    F = 9
    return {"single": dict(real=poses(B), cam16=f32(bank[rng.integers(0, len(bank), B)]),
                           tgt2d=f32(rng.normal(size=(B, 16, 2)) * 0.3),
                           critics=draws(B, 1), gen=draws(B, 1)),
            "video": dict(real=poses(Bv * F).reshape(Bv, F, 16, 3),
                          cam16=f32(bank[rng.integers(0, len(bank), Bv)]),
                          tgt2d=f32(rng.normal(size=(Bv, F, 16, 2)) * 0.3),
                          critics=draws(Bv, F), gen=draws(Bv, F)),
            "posenet": dict(x=f32(rng.normal(size=(B, 16, 2)) * 0.3),
                            y=f32(rng.normal(size=(B, 16, 3)) * 0.3))}


class HalvesForward:
    """A net whose forward runs the batch in two halves and concatenates
    them; everything else is the net's."""

    def __init__(self, net):
        self.net = net

    def __call__(self, x):
        import torch
        return torch.cat([self.net(h) for h in x.chunk(2)])

    def __getattr__(self, name):
        return getattr(self.net, name)


def dp_witness(inputs: dict, control: str = "", width: int = DP_WIDTH,
               device: str = "cuda:0") -> dict:
    """The witness's steps (see above) in this process or on each rank of
    ``mesh.launch``, from nets seeded alike (and broadcast from rank 0):
    returns each net's update (after - before) and the sum of its SGD
    steps (lr x gradient, free of the rounding of storing the weights,
    which alone is an ulp of the weight), the critic phases'
    scalars (the ranks' mean), the MLP's batch-norm statistics and loss,
    and this process's B1/B2/B3 launches.  ``control`` 'rows' takes the
    first half of every global input (one rank's rows, alone); 'halves'
    runs every GAN net's forward in two halves of the batch.  On a model
    axis of more than one rank (``mesh.launch(model_parallel=M)``) every
    net's wide layers are column-parallel (``parallel/tensor.py``) and
    the updates come back in the single-device layout; ``control``
    'blocks' computes each such layer here as M column blocks
    concatenated (the products a rank gives cuBLAS), and 'gather_sums'
    makes the ranks' gather backward sum the blocks of its cotangent
    instead of taking this rank's.  A rank runs on its own device; this
    process on ``device``."""
    import torch
    from dhaug_torch.gan import video, wgan
    from dhaug_torch.models import discriminators, generator
    from dhaug_torch.models.factory import make_posenet
    from dhaug_torch.parallel import mesh, tensor
    from dhaug_torch.train import posenet as train

    dp = mesh.current()
    device = dp.device if dp.device is not None else torch.device(device)
    if control == "gather_sums":
        tensor._Gather.backward = staticmethod(
            lambda ctx, g: (sum(g.chunk(mesh.current().model.world, ctx.dim)), None))

    def place(net):
        tensor.shard_module_tp(net)
        if control == "blocks":
            column_blocks(net, TP_DEVICES_M)
        return net
    steps_of = {}          # lr x the gradient of every SGD step, summed

    def keep_step(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    steps_of[id(p)] = steps_of.get(id(p), 0.0) + group["lr"] * p.grad.detach()

    on = lambda a: torch.as_tensor(a[: len(a) // 2] if control == "rows" else a, device=device)
    cams = wgan.camera_bank(DP_SUBJECTS, device)
    nets, metrics = {}, {}

    def build(prefix, seed, make):
        torch.manual_seed(seed)
        made = [place(n.to(device)) for n in make()]
        dp.broadcast_modules(*made)
        names = ["gen", "d3d", "d2d", "md3d", "md2d"][:len(made)]
        nets.update({prefix + k: n for k, n in zip(names, made)})
        opts = [torch.optim.SGD(n.parameters(), lr=DP_SGD_LR[prefix + k])
                for k, n in zip(names, made)]
        for opt in opts:
            opt.register_step_pre_hook(keep_step)
        return made, opts

    cfg = generator.GeneratorConfig(dense_dim=width)
    made, opts = build("", 0, lambda: [generator.FkGeneratorNet(cfg),
                                       discriminators.Fk3DDiscriminator(width),
                                       discriminators.Fk2DDiscriminator(width)])
    vcfg = generator.GeneratorConfig(dense_dim=width, video_frames=9)
    vmade, vopts = build("v_", 1, lambda: [generator.FkGeneratorNet(vcfg),
                                           discriminators.Fk3DDiscriminator(width),
                                           discriminators.Fk2DDiscriminator(width),
                                           discriminators.MotionFk3DDiscriminator(9, width),
                                           discriminators.MotionFk2DDiscriminator(9, width)])
    torch.manual_seed(2)
    mlp = place(make_posenet("mlp", stages=4, dropout=0.25).to(device))
    dp.broadcast_modules(mlp)
    nets["posenet"] = mlp
    before = {name: {k: p.detach().clone() for k, p in n.named_parameters()}
              for name, n in nets.items()}

    steps = wgan.SingleFrameSteps(*made, *opts, cfg, wgan.GanHyper(), *cams)
    vsteps = video.VideoSteps(*vmade, *vopts, vcfg, wgan.GanHyper(), *cams, playback=True)
    for label, st, extra in (("single", steps, ()), ("video", vsteps, (True,))):
        if control == "halves":
            for name in ("gen", "d3d", "d2d", "md3d", "md2d"):
                if hasattr(st, name):
                    setattr(st, name, HalvesForward(getattr(st, name)))
        x, d, g = inputs[label], inputs[label]["critics"], inputs[label]["gen"]
        cam_idx, bone_len, *_, m = st.critics_step(
            dp.rows(on(x["real"])), dp.rows(on(x["cam16"])), dp.rows(on(x["tgt2d"])), None,
            *extra, noise=on(d["noise"]), scaler8=on(d["scaler8"]),
            cam_idx=torch.tensor(d["cam_idx"]), alphas=[on(a) for a in d["alphas"]])
        gm = st.generator_step(bone_len, cam_idx, None, *extra, noise=on(g["noise"]),
                               scaler8=on(g["scaler8"]))
        metrics[label] = {k: float(dp.mean(v)) for k, v in {**m, **gm}.items()}
    x = inputs["posenet"]
    opt = torch.optim.SGD(mlp.parameters(), lr=DP_SGD_LR["posenet"])
    opt.register_step_pre_hook(keep_step)
    loss = train.train_step(mlp, opt, dp.rows(on(x["x"])), dp.rows(on(x["y"])), 1.0,
                            torch.Generator(device).manual_seed(3))
    return {"updates": {name: whole(n, {k: p.detach() - before[name][k]
                                        for k, p in n.named_parameters()})
                        for name, n in nets.items()},
            "steps": {name: whole(n, {k: torch.as_tensor(steps_of.get(id(p), 0.0), device=device)
                                      .expand_as(p) for k, p in n.named_parameters()})
                      for name, n in nets.items()},
            "metrics": metrics, "loss": float(dp.mean(loss)),
            "bn": {k: v.detach().cpu() for k, v in mlp.named_buffers() if "running" in k},
            "launches": mesh.kernel_launches()}


def whole(net, tensors: dict) -> dict:
    """``tensors`` by parameter name of ``net``, on the CPU, each column
    block gathered over the model group (``parallel/tensor.py``)."""
    from dhaug_torch.parallel import mesh
    from dhaug_torch.parallel.tensor import sharded_parameters
    blocks = {id(p) for p in sharded_parameters(net)}
    axis = mesh.current().model
    return {k: (axis.all_gather(tensors[k].contiguous(), 0) if id(p) in blocks
                else tensors[k]).cpu() for k, p in net.named_parameters()}


def column_blocks(net, m: int, min_width: int = 512) -> None:
    """Swap, in place, each ``nn.Linear`` of ``net`` with an output width
    of at least ``min_width`` dividing by ``m`` for one that computes its
    product as ``m`` column blocks concatenated: the products one rank of
    a model axis of ``m`` gives cuBLAS, on the same parameters."""
    import torch
    from torch import nn
    from torch.nn import functional as F

    class Blocks(nn.Module):
        def __init__(self, layer):
            super().__init__()
            self.weight, self.bias = layer.weight, layer.bias

        def forward(self, x, dtype=None):
            return torch.cat([F.linear(x, w, b) for w, b in
                              zip(self.weight.chunk(m), self.bias.chunk(m))], -1)

    for parent in list(net.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is nn.Linear and child.out_features >= min_width \
                    and child.out_features % m == 0:
                setattr(parent, name, Blocks(child))


def update_gaps(got: dict, want: dict) -> dict:
    """By net: the largest gap of an updated weight (``max_abs``), and the
    largest gap of a summed SGD step over the net's largest step element
    (``of_largest``)."""
    out = {}
    for name, ref in want["steps"].items():
        weights = max(float((got["updates"][name][k] - v).abs().max())
                      for k, v in want["updates"][name].items())
        gap = max(float((got["steps"][name][k] - v).abs().max()) for k, v in ref.items())
        size = max(float(v.abs().max()) for v in ref.values())
        out[name] = {"max_abs": weights, "of_largest": gap / size if size else float("inf")}
    return out


def metric_gaps(got: dict, want: dict) -> dict:
    """Each critic phase scalar's gap over the larger of the value, the
    critic's mean scores and 1 (as grid_run scales the estimates)."""
    out = {}
    for label, ref in want["metrics"].items():
        for k, v in ref.items():
            prefix = k.rsplit("wasserstein", 1)[0] if "wasserstein" in k else None
            scores = [abs(ref[prefix + p]) for p in ("d_real", "d_fake")
                      if prefix is not None and prefix + p in ref]
            out[f"{label}.{k}"] = abs(got["metrics"][label][k] - v) / max([1.0, abs(v)] + scores)
    return out


def dp_sgd_witness(fk_cuda, trunk_cuda) -> dict:
    """The full-width SGD witness (see above): two gloo ranks on cuda:0
    against one rank running its nets' forwards in halves, with the plain
    one-rank run and the one-rank-rows control beside them."""
    import torch
    from dhaug_torch.parallel import mesh

    inputs = dp_witness_inputs()
    reset_counts(fk_cuda, trunk_cuda)
    halves = dp_witness(inputs, "halves")
    one_launches = read_counts(fk_cuda, trunk_cuda)
    one = dp_witness(inputs)
    rows = dp_witness(inputs, "rows")
    t0 = time.perf_counter()
    ranks = mesh.launch("chip_smoke:dp_witness", (inputs,), DP_DEVICES, "gloo")
    wall = time.perf_counter() - t0
    two = update_gaps(ranks[0], halves)
    control = update_gaps(rows, halves)
    bn_gap = max(float((ranks[0]["bn"][k] - v).abs().max()) for k, v in halves["bn"].items())
    m_two = metric_gaps(ranks[0], halves)
    same = all(all(torch.equal(ranks[0]["updates"][n][k], ranks[1]["updates"][n][k])
                   for k in ranks[0]["updates"][n]) for n in ranks[0]["updates"])
    emit({"phase": "data_parallel", "path": "sgd_witness", "ranks": len(ranks),
          "launcher_wall_s": wall, "update_gaps": two, "control_one_rank_rows": control,
          "update_tol": DP_UPDATE_TOL, "bn_stat_gap": bn_gap,
          "loss_gap": abs(ranks[0]["loss"] - halves["loss"]),
          "metric_gaps": m_two, "metric_tol": DP_METRIC_TOL,
          "plain_one_rank": {"update_gaps_two_ranks": update_gaps(ranks[0], one),
                             "update_gaps_halves": update_gaps(halves, one),
                             "metric_gaps_two_ranks": metric_gaps(ranks[0], one),
                             "metric_gaps_halves": metric_gaps(halves, one)},
          "ranks_identical": same,
          "rank_launches": [r["launches"] for r in ranks], "one_rank_launches": one_launches})
    bad = {f"{n}.of_largest": g["of_largest"] for n, g in two.items()
           if not g["of_largest"] <= DP_UPDATE_TOL}
    bad.update({k: v for k, v in m_two.items() if not v <= DP_METRIC_TOL})
    if not bn_gap <= 1e-6:
        bad["bn"] = bn_gap
    if not same:
        bad["ranks_identical"] = False
    want = {k: one_launches[k] for k in ("fwd", "bwd")}
    if any({k: r["launches"][k] for k in want} != want for r in ranks):
        bad["launches"] = [r["launches"] for r in ranks]
    if not all(g["of_largest"] > DP_UPDATE_TOL for n, g in control.items()):
        bad["control_within_bound"] = control
    if bad:
        raise AssertionError(f"SGD witness: two ranks differ from one beyond the bounds: {bad}")
    return {"one_rank": one_launches, **{f"rank{r}": x["launches"] for r, x in enumerate(ranks)}}


def net_weights(result) -> dict:
    """A copy of a run's trained weights by net (the GAN's, the posenet's),
    taken before anything trains them further."""
    gan = result["gan"]
    nets = {"posenet": result["posenet"]}
    if gan is not None:
        nets.update(gen=gan.gen, d3d=gan.d3d, d2d=gan.d2d)
        if hasattr(gan, "md3d"):
            nets.update(md3d=gan.md3d, md2d=gan.md2d)
    return {name: {"params": {k: v.detach().clone() for k, v in net.named_parameters()},
                   "buffers": {k: v.detach().clone() for k, v in net.named_buffers()
                               if v.is_floating_point()}}
            for name, net in nets.items()}


def weight_gaps(got: dict, want: dict) -> dict:
    """By net: the largest gap of a parameter and of a batch-norm buffer."""
    gap = lambda name, kind: max((float((got[name][kind][k].to(v.device) - v).abs().max())
                                  for k, v in want[name][kind].items()), default=0.0)
    return {name: {"params_max_abs": gap(name, "params"), "buffers_max_abs": gap(name, "buffers")}
            for name in want}


def iteration_scalars(run_dir: Path, tag: str) -> dict:
    """A run's per-iteration scalar ``tag`` from its metrics.jsonl."""
    out = {}
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        row = json.loads(line)
        if row["tag"] == tag:
            out[row["step"]] = row["value"]
    return out


class BusySampler:
    """Samples ``nvidia-smi``'s utilization.gpu (the share of each sample
    period in which a kernel ran on the card, from any process) every
    100 ms while the block runs: the busy share of work spread over
    several processes, which torch.profiler in one process cannot see."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        samples = [int(x) for x in out.split() if x.strip().isdigit()]
        self.samples = len(samples)
        self.busy = sum(samples) / (100.0 * len(samples)) if samples else None
        return False


def rank_run(module: str, argv: list) -> dict:
    """``mesh.run_main(module, argv)`` on a rank of ``mesh.launch``, with
    the trained nets' weights (``net_weights``: this rank's column blocks)
    beside, from every rank."""
    import importlib
    from dhaug_torch.parallel import mesh
    mod, kept = importlib.import_module(module), {}
    main = mod.main

    def keep(argv):
        result = main(argv)
        kept["weights"] = net_weights(result)
        return result

    mod.main = keep
    out = mesh.run_main(module, argv)
    out["weights"] = kept["weights"]
    return out


def joined_weights(ranks: list, reference: dict) -> dict:
    """The ranks' trained weights in the single-device layout of
    ``reference``: a tensor whose shape is not the reference's is a column
    block, and the model group's blocks are concatenated."""
    import torch

    def join(name, kind, k):
        parts = [r[name][kind][k] for r in ranks]
        return parts[0] if parts[0].shape == reference[name][kind][k].shape else torch.cat(parts)
    return {name: {kind: {k: join(name, kind, k) for k in ref[kind]} for kind in ref}
            for name, ref in reference.items()}


def grid_run(phase: str, label: str, args: list, reference: dict, tags,
             model_parallel: int = 1) -> dict:
    """``args`` on two gloo ranks sharing cuda:0 through the library
    launcher (two data ranks, or with ``model_parallel`` 2 one model group
    of two), the card's busy share sampled meanwhile (BusySampler),
    against the one-rank ``reference`` run of the same command: each rank's
    B1/B2 launches and the first iteration's Wasserstein estimates ``tags``
    are held; the later iterations' gaps, the trained weights' gaps and the
    H36M P1 are printed."""
    from dhaug_torch.parallel import mesh
    t0, started = time.perf_counter(), time.time()
    with BusySampler() as sampler:
        if model_parallel == 1:
            result = mesh.launch_main("dhaug_torch.run_fk_gan", args, DP_DEVICES, "gloo")
        else:
            every = mesh.launch("chip_smoke:rank_run", ("dhaug_torch.run_fk_gan", args),
                                DP_DEVICES, "gloo", model_parallel=model_parallel)
            result = every[0]
            result["rank_launches"] = [r.pop("launches") for r in every]
            result["ranks"] = [r.pop("rank") for r in every]
    wall = time.perf_counter() - t0
    ranks = result["ranks"]
    # the launcher's own seconds: starting the ranks until each starts its
    # run, and from the last run's end to its result loaded here
    overhead = {"to_run_s": [r["started_at"] - started for r in ranks],
                "after_run_s": started + wall - max(r["ended_at"] for r in ranks)}
    weights = net_weights(result) if model_parallel == 1 else \
        joined_weights([r["weights"] for r in every], reference["nets"])
    gaps = weight_gaps(weights, reference["nets"])
    w_first, w_gaps = {}, {}
    for tag in tags:
        got = iteration_scalars(Path(result["run_dir"]), tag)
        want = iteration_scalars(reference["run_dir"], tag)
        if sorted(got) != sorted(want) or not want:
            raise AssertionError(f"{label}: iterations of {tag}: {sorted(got)} vs {sorted(want)}")
        # each gap over the larger of the critic's mean scores and 1, as
        # tests/test_torch_video.py scales it (an estimate is a difference
        # of two scores, and can cancel)
        scores = [iteration_scalars(reference["run_dir"], tag.replace("Wasserstein_D", part))
                  for part in ("D_real", "D_fake")]
        scale = {i: max([1.0, abs(want[i])] + [abs(s[i]) for s in scores if i in s])
                 for i in want}
        w_gaps[tag] = [abs(got[i] - want[i]) / scale[i] for i in sorted(want)]
        if 0 in want:     # the motion critics join later, on updated nets
            w_first[tag] = w_gaps[tag][0]
    p1_gap = abs(result["scores"]["h36m"]["p1"] - reference["scores"]["h36m"]["p1"])
    emit({"phase": phase, "path": label, "ranks": len(ranks), "backend": "gloo",
          "model_parallel": model_parallel,
          "launcher_wall_s": wall, "launcher_overhead": overhead,
          "rank_wall_s": [r["wall_s"] for r in ranks],
          "epoch_seconds": result["epoch_seconds"],
          "one_rank_epoch_seconds": reference["epoch_seconds"],
          "one_rank_seconds": reference["seconds"],
          "busy_share_of_launcher_wall": sampler.busy, "busy_samples": sampler.samples,
          "collective_calls": [r["collective_calls"] for r in ranks],
          "collective_s": [r["collective_s"] for r in ranks],
          "collective_share": [r["collective_s"] / r["wall_s"] for r in ranks],
          "rank_launches": result["rank_launches"], "one_rank_launches": reference["launches"],
          "weight_gaps": gaps, "wasserstein_rel_gap_by_iteration": w_gaps,
          "h36m_p1": result["scores"]["h36m"]["p1"],
          "one_rank_h36m_p1": reference["scores"]["h36m"]["p1"], "h36m_p1_gap_mm": p1_gap})
    check_scores(label, result["scores"])
    want = {k: reference["launches"][k] for k in ("fwd", "bwd")}
    for r, counts in enumerate(result["rank_launches"]):
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"{label}: rank {r} launched {counts}, one rank {want}")
    bad = {k: v for k, v in w_first.items() if not v <= DP_WASSERSTEIN_TOL}
    if bad:
        raise AssertionError(f"{label}: two ranks differ from one beyond the bounds: {bad}")
    return result["rank_launches"]


def dp_synthesis(fk_cuda, trunk_cuda, snapshot: Path, one_process: dict) -> list:
    """(e) ``python -m dhaug_torch.synthesize_dataset`` as two processes on
    cuda:0 joined by ``--coordinator``: B3 and B1 at 4096 rows a process
    and batch; process 0's npz must equal the two shards' streams run in
    this process, and keep every bone in the scaler range.  Beside it the
    same command as one fresh process (its loop, like theirs, pays the
    process's first launches; the synth phase's ran warm)."""
    import numpy as np
    import torch
    from dhaug_torch.gan.wgan import camera_bank
    from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
    from dhaug_torch.ops.bones import bone_lengths_fk
    from dhaug_torch.ops.fk import CANONICAL_BONE_LEN
    from dhaug_torch.parallel import mesh
    from dhaug_torch.parallel.sharded import make_sharded_synthesizer, stream
    from dhaug_torch import synthesize_dataset
    from dhaug_torch.utils.checkpoint import load_snapshot, restore_into

    out = REPO / "_runs" / "chip_smoke" / "dh_synth_2proc.npz"
    code = ("import json, sys\n"
            "from dhaug_torch import synthesize_dataset\n"
            "from dhaug_torch.parallel import mesh\n"
            "r = synthesize_dataset.main(sys.argv[1:])\n"
            "print(json.dumps({'launches': mesh.kernel_launches(), 'seconds': r['seconds'],\n"
            "                  'poses_per_s': r['poses_per_s']}))\n")
    flags = ["--ckpt", str(snapshot), "--n_poses", str(SYNTH_POSES), "--batch", str(SYNTH_B),
             "--Gen_DenseDim", str(SYNTH_D), "--device", "cuda", "--out", str(out),
             "--coordinator", f"localhost:{mesh.free_port()}", "--num_processes", "2"]
    one = subprocess.run([sys.executable, "-c", code, *flags[:-6], "--out",
                          str(out.with_name("dh_synth_1proc.npz"))], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if one.returncode != 0:
        raise AssertionError(f"one-process synthesis failed: {one.stderr[-3000:]}")
    one = json.loads(one.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    with BusySampler() as sampler:
        procs = [subprocess.Popen([sys.executable, "-c", code, *flags, "--process_id", str(i)],
                                  cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for i in range(2)]
        try:
            outputs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    wall = time.perf_counter() - t0
    for p, (stdout, stderr) in zip(procs, outputs):
        if p.returncode != 0:
            raise AssertionError(f"synthesis process failed ({p.returncode}): {stderr[-3000:]}")
    ranks = [json.loads(stdout.strip().splitlines()[-1]) for stdout, _ in outputs]
    n_batches = SYNTH_POSES // SYNTH_B
    for r in ranks:
        if r["launches"] != {"fwd": n_batches, "bwd": 0, "trunk": n_batches}:
            raise AssertionError(f"a synthesis process launched {r['launches']}")

    data = np.load(out)
    if int(data["n_devices"]) != 2 or data["pose3d"].shape != (SYNTH_POSES, 16, 3):
        raise AssertionError(f"npz n_devices {data['n_devices']}, shape {data['pose3d'].shape}")
    device = torch.device("cuda", 0)
    cfg = GeneratorConfig(dense_dim=SYNTH_D)
    net = FkGeneratorNet(cfg)
    restore_into(net, load_snapshot(str(snapshot))["gen_state"]["model"])
    ops = trunk_cuda.trunk_weights(net.to(device).eval())
    synthesize = make_sharded_synthesizer(cfg, n_devices=2)
    cameras = camera_bank(list(synthesize_dataset.CAMERA_SUBJECTS), device)
    bl = torch.tensor(CANONICAL_BONE_LEN, dtype=torch.float32, device=device)
    bone_len = bl.expand(SYNTH_B, 15).contiguous()
    gap = 0.0
    for i in range(n_batches):
        cam_idx = torch.randint(0, cameras[0].shape[0], (), generator=stream(device, 1, i),
                                device=device)
        cam3d, pose2d, _ = synthesize_dataset.synth_pairs(
            synthesize, ops, bone_len, cameras, [stream(device, 1, i, s) for s in range(2)],
            cam_idx=cam_idx)
        rows = slice(i * SYNTH_B, (i + 1) * SYNTH_B)
        gap = max(gap, float(np.abs(data["pose3d"][rows] - cam3d.cpu().numpy()).max()),
                  float(np.abs(data["pose2d"][rows] - pose2d.cpu().numpy()).max()))
    lengths = bone_lengths_fk(torch.from_numpy(data["pose3d"]))
    lo, hi = SCALER_RANGE
    blc = bl.cpu()
    below = float((lo * blc - lengths).max())
    above = float((lengths - hi * blc).max())
    emit({"phase": "data_parallel", "path": "synthesis", "processes": 2, "backend": "gloo",
          "wall_s": wall, "process_seconds": [r["seconds"] for r in ranks],
          "busy_share_of_wall": sampler.busy, "busy_samples": sampler.samples,
          "poses_per_s": ranks[0]["poses_per_s"],
          "one_process_cli_poses_per_s": one["poses_per_s"],
          "one_process_cli_seconds": one["seconds"],
          "synth_phase_poses_per_s": one_process["cli_poses_per_s"],
          "rank_launches": [r["launches"] for r in ranks], "max_gap_to_in_process": gap,
          "bone_len_below_m": below, "bone_len_above_m": above})
    if not gap <= 1e-6:
        raise AssertionError(f"2-process npz differs from the in-process shards by {gap}")
    if below > BONE_ATOL or above >= 0:
        raise AssertionError(f"2-process bone lengths outside the scaler range: {below} m "
                             f"below, {above} m above")
    return [r["launches"] for r in ranks]


def phase_data_parallel(fk_cuda, trunk_cuda, main_ref: dict, synth_ref: dict,
                        grid_refs: dict) -> dict:
    """--data_parallel_devices and multi-process synthesis on the one card:
    (a) the main command with --data_parallel_devices 2 must stop before
    any launch (one card visible); (b) the main command in an NCCL group of
    one rank on cuda:0 (every all-reduce and gather runs) must train the
    main phase's weights bit for bit; the full-width SGD witness (two gloo
    ranks vs one); (c) the main command on two gloo ranks sharing cuda:0
    (512 poses a rank in B1/B2) and (d) the video command (2304 poses a
    rank), each cut in depth (GRID_MAIN_ARGS, GRID_VIDEO_ARGS), against
    the same commands on one rank (``grid_refs``); (e) synthesis in two
    processes.  Two ranks on one card compete
    for it: their times are no scaling number."""
    import torch
    from dhaug_torch import run_fk_gan
    from dhaug_torch.parallel import mesh

    launches = {}
    reset_counts(fk_cuda, trunk_cuda)
    args = MAIN_ARGS + ["--data_parallel_devices", "2", "--data_root", str(REPO),
                        "--checkpoint", str(REPO / "_runs" / "chip_smoke_dp_refused")]
    try:
        run_fk_gan.main(args)
        raise AssertionError("--data_parallel_devices 2 ran on one card")
    except SystemExit as exc:
        message = str(exc)
    launches["dp_refused"] = read_counts(fk_cuda, trunk_cuda)
    emit({"phase": "data_parallel", "path": "refused", "message": message,
          "launches": launches["dp_refused"]})
    if "requests 2 devices but only 1 device(s)" not in message or \
            any(launches["dp_refused"].values()):
        raise AssertionError(f"refusal: {message!r}, launches {launches['dp_refused']}")

    calls0 = mesh.COLLECTIVE_CALLS
    mesh.join("nccl", torch.device("cuda", 0), 0, 1, f"tcp://localhost:{mesh.free_port()}")
    try:
        args = MAIN_ARGS + ["--data_root", str(REPO),
                            "--checkpoint", str(REPO / "_runs" / "chip_smoke_dp_nccl1")]
        reset_counts(fk_cuda, trunk_cuda)
        t0 = time.perf_counter()
        result = run_fk_gan.main(args)
        seconds = time.perf_counter() - t0
        launches["dp_nccl_world1"] = read_counts(fk_cuda, trunk_cuda)
    finally:
        mesh.leave()
    weights = net_weights(result)
    differ = [f"{name}.{k}" for name, ref in main_ref["nets"].items()
              for kind in ("params", "buffers") for k, v in ref[kind].items()
              if not torch.equal(weights[name][kind][k], v)]
    emit({"phase": "data_parallel", "path": "nccl_world_1", "seconds": seconds,
          "epoch_seconds": result["epoch_seconds"], "launches": launches["dp_nccl_world1"],
          "collective_calls": mesh.COLLECTIVE_CALLS - calls0, "tensors_differing": differ})
    if differ or launches["dp_nccl_world1"] != main_ref["launches"] or \
            mesh.COLLECTIVE_CALLS == calls0:
        raise AssertionError(f"NCCL world 1: {len(differ)} tensors differ from the one-device "
                             f"run ({differ[:5]}), launches {launches['dp_nccl_world1']}")

    for who, counts in dp_sgd_witness(fk_cuda, trunk_cuda).items():
        launches[f"dp_sgd_witness_{who}"] = counts
    tags = ["train_G_iter_PoseFk/Fk_d3d_Wasserstein_D", "train_G_iter_PoseFk/d2d_Wasserstein_D"]
    args = GRID_MAIN_ARGS + ["--data_parallel_devices", "2",
                             "--checkpoint", str(REPO / "_runs" / "chip_smoke_dp_main")]
    for r, counts in enumerate(grid_run("data_parallel", "main_2_ranks", args, grid_refs["main"],
                                        tags)):
        launches[f"dp_main_rank{r}"] = counts
    args = GRID_VIDEO_ARGS + ["--data_parallel_devices", "2",
                              "--checkpoint", str(REPO / "_runs" / "chip_smoke_dp_video")]
    tags += ["train_G_iter_PoseFk/motion_Fk_d3d_Wasserstein_D",
             "train_G_iter_PoseFk/motion_d2d_Wasserstein_D"]
    for r, counts in enumerate(grid_run("data_parallel", "video_2_ranks", args,
                                        grid_refs["video"], tags)):
        launches[f"dp_video_rank{r}"] = counts
    for r, counts in enumerate(dp_synthesis(fk_cuda, trunk_cuda, main_ref["run_dir"] /
                                            "ckpt_resume_latest.ckpt", synth_ref)):
        launches[f"dp_synth_process{r}"] = counts
    return launches


# tensor_parallel: a model group of two gloo ranks sharing the one card
# against one rank.
#
# Each GAN net's and the MLP's layers of 512 or more outputs hold half
# their output rows on each rank (parallel/tensor.py); activations are
# whole on both.  The SGD witness of data_parallel is run on that model
# group (one critic phase and generator update of each GAN at full width
# and the commands' batches, one MLP step), and its reference is one rank
# that computes each wide layer as two column blocks concatenated
# (column_blocks): the products a rank gives cuBLAS, whose kernels for
# other shapes moved the data-parallel witness's plain one-rank gaps.
# Bounds are the data-parallel witness's: each net's summed SGD steps
# within DP_UPDATE_TOL of its largest step element, batch-norm statistics
# 1e-6, critic scalars DP_METRIC_TOL.  The control sums the blocks of the
# gather's cotangent instead of slicing it (a backward that is wrong only
# under tensor parallelism), and must exceed the bound on every net.  Then
# the main and video commands on the model group against the main and
# video phases' runs, as data_parallel (c) and (d) do.
TP_DEVICES_M = 2


def tp_sgd_witness(fk_cuda, trunk_cuda, width: int = DP_WIDTH, devices=DP_DEVICES,
                   inputs=None) -> dict:
    """The full-width SGD witness (see above) on a model group of two
    ranks on ``devices``; ``width`` and ``inputs`` (``dp_witness_inputs``)
    are there to rehearse it small."""
    import torch
    from dhaug_torch.parallel import mesh

    inputs = dp_witness_inputs() if inputs is None else inputs
    reset_counts(fk_cuda, trunk_cuda)
    blocks = dp_witness(inputs, "blocks", width, devices[0])
    one_launches = read_counts(fk_cuda, trunk_cuda)
    one = dp_witness(inputs, "", width, devices[0])
    t0 = time.perf_counter()
    pairs = mesh.launch("chip_smoke:tp_witness_pair", (inputs, width), devices, "gloo",
                        model_parallel=TP_DEVICES_M)
    wall = time.perf_counter() - t0
    ranks, wrong = [p[0] for p in pairs], [p[1] for p in pairs]
    two = update_gaps(ranks[0], blocks)
    control = update_gaps(wrong[0], blocks)
    bn_gap = max(float((ranks[0]["bn"][k] - v).abs().max()) for k, v in blocks["bn"].items())
    m_two = metric_gaps(ranks[0], blocks)
    same = all(all(torch.equal(ranks[0]["updates"][n][k], ranks[1]["updates"][n][k])
                   for k in ranks[0]["updates"][n]) for n in ranks[0]["updates"])
    emit({"phase": "tensor_parallel", "path": "sgd_witness", "ranks": len(ranks),
          "model_parallel": TP_DEVICES_M, "launcher_wall_s": wall, "update_gaps": two,
          "control_gather_backward_summed": control, "update_tol": DP_UPDATE_TOL,
          "bn_stat_gap": bn_gap, "loss_gap": abs(ranks[0]["loss"] - blocks["loss"]),
          "metric_gaps": m_two, "metric_tol": DP_METRIC_TOL,
          "plain_one_rank": {"update_gaps_model_group": update_gaps(ranks[0], one),
                             "update_gaps_blocks": update_gaps(blocks, one),
                             "metric_gaps_model_group": metric_gaps(ranks[0], one)},
          "ranks_identical": same,
          "rank_launches": [r["launches"] for r in ranks], "one_rank_launches": one_launches})
    bad = {f"{n}.of_largest": g["of_largest"] for n, g in two.items()
           if not g["of_largest"] <= DP_UPDATE_TOL}
    bad.update({k: v for k, v in m_two.items() if not v <= DP_METRIC_TOL})
    if not bn_gap <= 1e-6:
        bad["bn"] = bn_gap
    if not same:
        bad["ranks_identical"] = False
    want = {k: one_launches[k] for k in ("fwd", "bwd")}
    if any({k: r["launches"][k] for k in want} != want for r in ranks):
        bad["launches"] = [r["launches"] for r in ranks]
    if not all(g["of_largest"] > DP_UPDATE_TOL for g in control.values()):
        bad["control_within_bound"] = control
    if bad:
        raise AssertionError(f"TP SGD witness: the model group differs from one rank beyond "
                             f"the bounds: {bad}")
    return {"one_rank": one_launches, **{f"rank{r}": x["launches"] for r, x in enumerate(ranks)}}


def tp_witness_pair(inputs: dict, width: int) -> tuple:
    """A rank's witness on the model group, then its control
    ('gather_sums', which patches the gather's backward for the rest of
    the process), in one launch; the witness's launches are its own."""
    return dp_witness(inputs, "", width), dp_witness(inputs, "gather_sums", width)


def one_rank_run(fk_cuda, trunk_cuda, args: list) -> dict:
    """``run_fk_gan.main(args)`` in this process as a reference for
    grid_run: its trained weights, run directory, launches, scores and
    seconds."""
    from dhaug_torch import run_fk_gan
    reset_counts(fk_cuda, trunk_cuda)
    t0 = time.perf_counter()
    result = run_fk_gan.main(args)
    seconds = time.perf_counter() - t0
    return {"nets": net_weights(result), "run_dir": Path(result["run_dir"]),
            "launches": read_counts(fk_cuda, trunk_cuda), "scores": result["scores"],
            "epoch_seconds": result["epoch_seconds"], "seconds": seconds}


def phase_tensor_parallel(fk_cuda, trunk_cuda, grid_refs: dict) -> dict:
    """--model_parallel_devices on the one card: (a) the main command with
    --model_parallel_devices 2 must stop before any launch (one card
    visible); (b) the full-width SGD witness (a model group of two gloo
    ranks vs one rank computing column blocks, beside a control that must
    fail); (c) the main command and (d) the video command, each cut in
    depth (GRID_MAIN_ARGS, GRID_VIDEO_ARGS), on a model group of two gloo
    ranks sharing cuda:0 against the same commands on one rank
    (``grid_refs``).  Two ranks on one card compete for it: their times
    are no scaling number."""
    from dhaug_torch import run_fk_gan

    launches = {}
    reset_counts(fk_cuda, trunk_cuda)
    args = MAIN_ARGS + ["--model_parallel_devices", "2", "--data_root", str(REPO),
                        "--checkpoint", str(REPO / "_runs" / "chip_smoke_tp_refused")]
    try:
        run_fk_gan.main(args)
        raise AssertionError("--model_parallel_devices 2 ran on one card")
    except SystemExit as exc:
        message = str(exc)
    launches["tp_refused"] = read_counts(fk_cuda, trunk_cuda)
    emit({"phase": "tensor_parallel", "path": "refused", "message": message,
          "launches": launches["tp_refused"]})
    if "--data_parallel_devices 1 x --model_parallel_devices 2 requests 2 devices but only " \
            "1 device(s)" not in message or any(launches["tp_refused"].values()):
        raise AssertionError(f"refusal: {message!r}, launches {launches['tp_refused']}")

    for who, counts in tp_sgd_witness(fk_cuda, trunk_cuda).items():
        launches[f"tp_sgd_witness_{who}"] = counts
    flag = ["--model_parallel_devices", str(TP_DEVICES_M)]
    tags = ["train_G_iter_PoseFk/Fk_d3d_Wasserstein_D", "train_G_iter_PoseFk/d2d_Wasserstein_D"]
    args = GRID_MAIN_ARGS + flag + ["--checkpoint", str(REPO / "_runs" / "chip_smoke_tp_main")]
    for r, counts in enumerate(grid_run("tensor_parallel", "main_model_group_2", args,
                                        grid_refs["main"], tags, TP_DEVICES_M)):
        launches[f"tp_main_rank{r}"] = counts
    args = GRID_VIDEO_ARGS + flag + ["--checkpoint", str(REPO / "_runs" / "chip_smoke_tp_video")]
    tags += ["train_G_iter_PoseFk/motion_Fk_d3d_Wasserstein_D",
             "train_G_iter_PoseFk/motion_d2d_Wasserstein_D"]
    for r, counts in enumerate(grid_run("tensor_parallel", "video_model_group_2", args,
                                        grid_refs["video"], tags, TP_DEVICES_M)):
        launches[f"tp_video_rank{r}"] = counts
    return launches


def main() -> int:
    started = time.perf_counter()
    if not (REPO / "dhaug_torch" / "__init__.py").is_file():
        print("chip_smoke.py: the dhaug_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from dhaug_torch.models import trunk_cuda
    from dhaug_torch.ops import cuda_lib
    from dhaug_torch.ops import fk as fk_plain
    from dhaug_torch.ops import fk_cuda
    t0 = time.perf_counter()
    cuda_lib.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {k: v["seconds"] for k, v in cuda_lib.BUILD_INFO.items()},
          "ptxas": [line.strip() for info in cuda_lib.BUILD_INFO.values()
                    for line in info["ptxas"].splitlines()
                    if "registers" in line or "spill" in line or "Compiling entry" in line
                    or "smem" in line]})

    fwd_err, bwd_err, times, fwd_bound, bwd_bound = phase_kernels(fk_plain, fk_cuda, device)
    trunk_err, trunk_times, trunk_bound = phase_trunk_kernel(trunk_cuda, device)
    main_launches, gan, run_dir, main_ref = phase_main(fk_cuda, trunk_cuda, device)
    phase_profile(gan, device)
    synth_launches, synth_ref = phase_synth(fk_cuda, trunk_cuda, run_dir, device)
    posenet_launches, posenet_dirs = phase_posenets(fk_cuda, trunk_cuda)
    augment_launches = phase_augment(fk_cuda, trunk_cuda)
    baseline_launches = phase_baseline(fk_cuda, trunk_cuda, posenet_dirs["gcn"])
    video_launches = phase_video(fk_cuda, trunk_cuda)
    extras_launches = phase_cli_extras(fk_cuda, trunk_cuda, device, main_ref)
    t0 = time.perf_counter()
    tools_launches = phase_tools(fk_cuda, trunk_cuda, device)
    emit({"phase": "tools", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    prepare_launches = phase_prepare(fk_cuda, trunk_cuda, device)
    emit({"phase": "prepare", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    bench_path = phase_bench(fk_cuda, trunk_cuda, device)
    emit({"phase": "bench", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    grid_refs, grid_launches = grid_references(fk_cuda, trunk_cuda)
    dp_launches = phase_data_parallel(fk_cuda, trunk_cuda, main_ref, synth_ref, grid_refs)
    emit({"phase": "data_parallel", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    tp_launches = phase_tensor_parallel(fk_cuda, trunk_cuda, grid_refs)
    emit({"phase": "tensor_parallel", "seconds": time.perf_counter() - t0})

    paths = {"main": main_launches, "synth": synth_launches, **posenet_launches,
             **augment_launches, "baseline": baseline_launches, **video_launches,
             **extras_launches, **tools_launches, **prepare_launches, **bench_path,
             **grid_launches, **dp_launches, **tp_launches}
    by_path = lambda key: {path: counts[key] for path, counts in paths.items()}
    source = "dhaug_torch/csrc/fk_kernels.cu"

    def fk_times(key):
        """ms: device time a launch at B = 1024; beside it B = 4608 (the
        video clip batch) and 8192, the loop of launches, host µs a call
        and the launch floor."""
        i = 0 if key == "fwd" else 1
        return {"ms": times[f"{key}_device_us_1024"] / 1e3,
                "ms_at_4608": times[f"{key}_device_us_4608"] / 1e3,
                "ms_at_8192": times[f"{key}_device_us_8192"] / 1e3,
                "loop_ms": times[f"{key}_loop_ms_1024"],
                "loop_ms_at_4608": times[f"{key}_loop_ms_4608"],
                "loop_ms_at_8192": times[f"{key}_loop_ms_8192"],
                "host_us_per_call": times[f"{key}_host_us_1024"],
                "launch_floor_ms": times["floor_device_us"] / 1e3,
                "launch_floor_loop_ms": times["floor_loop_ms"],
                "bound_ms_at_4608": fk_bounds(4608)[i][0],
                "bound_ms_at_8192": fk_bounds(8192)[i][0]}
    kernels = [
        {"name": "fk_forward_kernel", "route": "cuda", "source": source,
         "replaces": "dhaug_tpu/ops/fk_pallas.py:105", "launches": main_launches["fwd"],
         "launches_by_path": by_path("fwd"),
         "max_abs_err": fwd_err, **fk_times("fwd"), "plain_ms": times["fwd_plain_ms"],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": None},
        {"name": "fk_backward_kernel", "route": "cuda", "source": source,
         "replaces": "dhaug_tpu/ops/fk_pallas.py:355", "launches": main_launches["bwd"],
         "launches_by_path": by_path("bwd"),
         "max_abs_err": bwd_err, **fk_times("bwd"), "plain_ms": times["bwd_plain_ms"],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": None},
        {"name": "trunk_gemm_kernel", "route": "cuda",
         "source": "dhaug_torch/csrc/trunk_kernels.cu",
         "replaces": "dhaug_tpu/models/trunk_pallas.py:52", "launches": synth_launches["trunk"],
         "launches_by_path": by_path("trunk"),
         "max_abs_err": trunk_err, "ms": trunk_times["ms"], "plain_ms": trunk_times["plain_ms"],
         "bound_ms": trunk_bound[0], "bound_by": trunk_bound[1],
         "library_ms": trunk_times["library_ms"]},
    ]
    emit({"phase": "done", "seconds": time.perf_counter() - started})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
