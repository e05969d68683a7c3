#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dhaug_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits non-zero:

1. device  -- the card's name, count and power limit (fails without a card);
2. build   -- builds the CUDA kernels from this checkout's sources with nvcc
              and prints ptxas' register/spill report;
3. kernels -- holds each kernel to its plain PyTorch version on the card at
              B = 1024 (the main path's batch), 1000 (ragged) and 1, and
              times kernel and plain version with CUDA events;
4. main    -- runs ``dhaug_torch.run_fk_gan.main`` with the README's
              single-frame FK-GAN command at full width (generator and both
              critics 1000 wide, MLP posenet 1024 wide with 4 stages,
              batch 1024) for 3 epochs, with the launch counters set to 0
              just before and read just after, and checks its results;
5. profile -- times GAN iterations at those shapes and reads the device's
              busy share and top kernels from torch.profiler.

Then it prints the ``nvidia-smi`` name/power-limit line, one ``kernels``
JSON line, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
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

MAIN_ARGS = ["--note", "chip_smoke", "--posenet_name", "mlp", "--lr_p", "1e-3",
             "--keypoints", "gt", "--batch_size", "1024",
             "--data_enhancement_method", "GAN", "--single_or_multi_train_mode", "single",
             "--epochs", "3", "--additional_train_epoch", "0", "--warmup", "0",
             "--device", "cuda"]


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


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FP32_FLOP_S
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


def phase_kernels(fk_plain, fk_cuda, device):
    """Both kernels against the plain FK (forward) and autograd through it
    (backward) at B = 1024, 1000, 1; then timings at B = 1024."""
    import torch
    fwd_err, bwd_err = 0.0, 0.0
    for B in (1024, 1000, 1):
        ang, bl, grot, root, cot = fk_inputs(B, seed=B, device=device)
        got = fk_cuda.fk_forward_cuda(ang, bl, grot, root)
        inputs = [t.clone().requires_grad_(True) for t in (ang, bl, grot, root)]
        ref = fk_plain.fk_world_pose_16(*inputs)
        ref_grads = torch.autograd.grad(ref, inputs, cot)
        got_grads = fk_cuda.fk_backward_cuda(ang, bl, grot, cot)
        torch.cuda.synchronize()
        err = float((got - ref.detach()).abs().max())
        if not err <= FWD_ATOL:
            raise AssertionError(f"forward kernel B={B}: max abs err {err} m > {FWD_ATOL}")
        fwd_err = max(fwd_err, err)
        for name, r, g in zip(("dangles", "dbone_len", "dglobal_rot", "droot"),
                              ref_grads, got_grads):
            if not torch.allclose(g, r, atol=BWD_ATOL, rtol=BWD_RTOL):
                raise AssertionError(f"backward kernel B={B} {name}: max abs err "
                                     f"{float((g - r).abs().max())} beyond atol {BWD_ATOL} "
                                     f"rtol {BWD_RTOL}")
            bwd_err = max(bwd_err, float((g - r).abs().max()))
        emit({"phase": "kernels", "B": B, "fwd_max_abs_err_m": err,
              "bwd_max_abs_err": max(float((g - r).abs().max())
                                     for r, g in zip(ref_grads, got_grads))})

    B = 1024
    ang, bl, grot, root, cot = fk_inputs(B, seed=7, device=device)
    inputs = [t.clone().requires_grad_(True) for t in (ang, bl, grot, root)]
    plain_out = fk_plain.fk_world_pose_16(*inputs)
    with torch.no_grad():
        times = {
            "fwd_ms": cuda_time_ms(lambda: fk_cuda.fk_forward_cuda(ang, bl, grot, root)),
            "fwd_plain_ms": cuda_time_ms(lambda: fk_plain.fk_world_pose_16(ang, bl, grot, root)),
            "bwd_ms": cuda_time_ms(lambda: fk_cuda.fk_backward_cuda(ang, bl, grot, cot)),
        }
    times["bwd_plain_ms"] = cuda_time_ms(
        lambda: torch.autograd.grad(plain_out, inputs, cot, retain_graph=True), iters=50)
    fwd_bound = bound_ms(B * (33 + 15 + 3 + 3 + 48) * 4, B * FWD_FLOP_PER_POSE)
    bwd_bound = bound_ms(B * (33 + 15 + 3 + 48 + 33 + 15 + 3 + 3) * 4, B * BWD_FLOP_PER_POSE)
    emit({"phase": "kernels", "B": B, **times,
          "fwd_bound_ms": fwd_bound[0], "bwd_bound_ms": bwd_bound[0]})
    return fwd_err, bwd_err, times, fwd_bound, bwd_bound


def phase_main(fk_cuda, device):
    """The README's single-frame FK-GAN command, 3 epochs at full width."""
    import torch
    from dhaug_torch import run_fk_gan
    from dhaug_torch.ops.bones import bone_lengths_fk

    args = MAIN_ARGS + ["--data_root", str(REPO),
                        "--checkpoint", str(REPO / "_runs" / "chip_smoke")]
    torch.cuda.reset_peak_memory_stats(device)
    fk_cuda.FWD_LAUNCHES = 0
    fk_cuda.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    result = run_fk_gan.main(args)
    seconds = time.perf_counter() - t0
    launches = {"fwd": fk_cuda.FWD_LAUNCHES, "bwd": fk_cuda.BWD_LAUNCHES}

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

    # bone-length canary on the trained generator: FK must reproduce the
    # (unscaled) bone lengths it was given
    gan = result["gan"]
    bl = torch.linspace(0.15, 0.6, 15, device=device).expand(256, 15).contiguous()
    with torch.no_grad():
        pose = gan.synth_fake(bl, None, scaler8=torch.zeros(256, 8, device=device))
    bl_err = float((bone_lengths_fk(pose) - bl).abs().max())
    if not (pose.shape == (256, 16, 3) and bl_err <= 1e-5):
        raise AssertionError(f"generated poses: shape {tuple(pose.shape)}, bone err {bl_err}")
    emit({"phase": "main", "bone_length_canary_max_err_m": bl_err})
    return launches, gan


def phase_profile(gan, device, iters: int = 10):
    """Where a GAN iteration's time goes at the main path's shapes (batch
    1024, nets 1000 wide): host wall per iteration (unprofiled), and from
    torch.profiler the device time of each kernel, whose sum over that wall
    is the device's busy share.  Runs after the main path, on its trained
    nets, outside the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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

    run(5)  # warm-up
    t0 = time.perf_counter()
    run(iters)
    wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(iters)
    prof_wall_us = (time.perf_counter() - t0) * 1e6
    # device time from kernel events only: a CPU op's self device time
    # repeats the time of the kernels it launched
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev = lambda e: e.self_device_time_total
    busy_us = sum(dev(e) for e in kernels)
    fk = {name: [dev(e) / e.count, e.count / iters]
          for name in ("fk_forward_kernel", "fk_backward_kernel")
          for e in kernels if name in e.key}
    top = sorted(kernels, key=dev, reverse=True)[:6]
    emit({"phase": "profile", "iters": iters, "gan_iter_ms": wall_ms / iters,
          "profiled_iter_ms": prof_wall_us / 1e3 / iters,
          "device_kernel_ms_per_iter": busy_us / 1e3 / iters,
          "device_busy_share": busy_us / 1e3 / wall_ms,
          "fk_kernel_device_us_per_call_and_calls_per_iter": fk,
          "top_kernels_device_ms_per_iter": [[e.key[:90], dev(e) / 1e3 / iters, e.count / iters]
                                             for e in top]})


def main() -> int:
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

    from dhaug_torch.ops import fk as fk_plain
    from dhaug_torch.ops import fk_cuda
    t0 = time.perf_counter()
    fk_cuda.build()
    ptxas = [line.strip() for line in fk_cuda.BUILD_INFO["ptxas"].splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": fk_cuda.BUILD_INFO["seconds"], "ptxas": ptxas})

    fwd_err, bwd_err, times, fwd_bound, bwd_bound = phase_kernels(fk_plain, fk_cuda, device)
    launches, gan = phase_main(fk_cuda, device)
    phase_profile(gan, device)

    source = "dhaug_torch/csrc/fk_kernels.cu"
    kernels = [
        {"name": "fk_forward_kernel", "route": "cuda", "source": source,
         "replaces": "dhaug_tpu/ops/fk_pallas.py:105", "launches": launches["fwd"],
         "max_abs_err": fwd_err, "ms": times["fwd_ms"], "plain_ms": times["fwd_plain_ms"],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": None},
        {"name": "fk_backward_kernel", "route": "cuda", "source": source,
         "replaces": "dhaug_tpu/ops/fk_pallas.py:355", "launches": launches["bwd"],
         "max_abs_err": bwd_err, "ms": times["bwd_ms"], "plain_ms": times["bwd_plain_ms"],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": None},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
