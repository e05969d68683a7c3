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
              B2 3), its iterations profiled.

Each run of phases 7-10 (but the poseformer's) is then run once more under
torch.profiler, outside
the counted run, for its device kernel time, busy share and top kernels.
Each path's launch counters are set to 0 just before it runs and read just
after.  Then it prints a ``done`` line with the script's seconds, the
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
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12     # H100 SXM fp32, outside the tensor cores
PEAK_BF16_FLOP_S = 989e12    # H100 SXM dense bf16 tensor cores

# fp32 adds and multiplies per pose, counted from csrc/fk_chain.cuh (sin/cos
# not counted): forward = 33 links x 8 (theta, Q, t) + 30 chain steps x 63
# (R t, p +=, R Q) + 27 (Euler) + 16 joints x 18 (Rg p + root); backward =
# the forward walk with the dRg/droot accumulation (~2.6 k) + the rotation
# recompute (~1.6 k) + 33 reverse steps of ~146 and the 16 joint cotangents.
FWD_FLOP_PER_POSE = 33 * 8 + 30 * 63 + 27 + 16 * 18
BWD_FLOP_PER_POSE = 2611 + 1614 + 33 * 146 + 16 * 18

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
# 3,3,3) and 8 x 9 (two full tiles and one of 8)
FK_CHECKED = ((1024, False), (1000, False), (1, False), (1027, False), (8192, False),
              (1027, True), (10000, False), (4608, False), (13824, False), (72, False))
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float, peak_flops: float = PEAK_FP32_FLOP_S):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def device_us(fn, name=None, calls: int = 30, warmup: int = 10) -> float:
    """Median device time (µs) of one launch of the kernel whose name holds
    ``name`` (any kernel when None), over ``calls`` calls of ``fn`` after
    warm-up, from torch.profiler's kernel events; each call must launch it
    once."""
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and (name is None or name in e.name)]
    # the profiler's activity buffer may drop an event now and then
    if not calls - 3 <= len(us) <= calls:
        raise AssertionError(f"profiled {len(us)} launches of {name}, expected {calls}")
    return statistics.median(us)


def host_us(fn, calls: int = 200, warmup: int = 20) -> float:
    """Host µs a call: a host clock over ``calls`` unsynchronized calls,
    then one synchronize (outside the clock)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


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
    at D = 64, B = 64 and D = 256, B = 333, to the rule of
    trunk_cuda.TRUNK_MAX_ERR / TRUNK_MEAN_ERR (max and mean absolute error
    over the std of the head); then timings and the per-layer profile at
    B = 8192."""
    import numpy as np
    import torch

    max_abs = 0.0
    for D, B in ((SYNTH_D, SYNTH_B), (SYNTH_D, 1000), (SYNTH_D, 1), (64, 64), (256, 333)):
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
    return launches, gan, run_dir


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


def device_kernels(prof) -> list:
    """The device-side events of a torch.profiler run (kernels and
    copies), without user annotations, whose device ranges only span
    kernels that are counted already."""
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]


def profile_iterations(run, iters: int) -> dict:
    """``run(n)`` runs n GAN iterations and synchronizes: after a warm-up,
    the host wall per iteration (unprofiled), and from torch.profiler the
    device time of each kernel, whose sum over that wall is the device's
    busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run(5)  # warm-up
    t0 = time.perf_counter()
    run(iters)
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(iters)
    prof_wall_us = (time.perf_counter() - t0) * 1e6
    # device time from kernel events only: a CPU op's self device time
    # repeats the time of the kernels it launched, and a user annotation's
    # device range (Optimizer.step#Adam.step) spans kernels counted already
    kernels = device_kernels(prof)
    dev = lambda e: e.self_device_time_total
    busy_us = sum(dev(e) for e in kernels)
    fk = {name: [dev(e) / e.count, e.count / iters]
          for name in ("fk_forward_kernel", "fk_backward_kernel")
          for e in kernels if name in e.key}
    top = sorted(kernels, key=dev, reverse=True)[:6]
    return {"iters": iters, "gan_iter_ms": wall_ms / iters,
            "profiled_iter_ms": prof_wall_us / 1e3 / iters,
            "device_kernel_ms_per_iter": busy_us / 1e3 / iters,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "fk_kernel_device_us_per_call_and_calls_per_iter": fk,
            "top_kernels_device_ms_per_iter": [[e.key[:90], dev(e) / 1e3 / iters,
                                                e.count / iters] for e in top]}


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
    return launches


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def phase_cli_extras(fk_cuda, trunk_cuda, device):
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
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
    main_launches, gan, run_dir = phase_main(fk_cuda, trunk_cuda, device)
    phase_profile(gan, device)
    synth_launches = phase_synth(fk_cuda, trunk_cuda, run_dir, device)
    posenet_launches, posenet_dirs = phase_posenets(fk_cuda, trunk_cuda)
    augment_launches = phase_augment(fk_cuda, trunk_cuda)
    baseline_launches = phase_baseline(fk_cuda, trunk_cuda, posenet_dirs["gcn"])
    video_launches = phase_video(fk_cuda, trunk_cuda)
    extras_launches = phase_cli_extras(fk_cuda, trunk_cuda, device)

    paths = {"main": main_launches, "synth": synth_launches, **posenet_launches,
             **augment_launches, "baseline": baseline_launches, **video_launches,
             **extras_launches}
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
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
