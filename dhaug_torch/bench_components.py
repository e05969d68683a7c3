"""Component timings on the card: the FK, the synthesis body, the GAN steps.

Port of ``scripts/bench_components.py``.  Reports, one JSON line each:

* ``fk`` -- the FK at ``--fk_batch`` (65536) poses: the plain PyTorch FK
  (``ops/fk.py``) against kernel B1 (``ops/fk_cuda.fk_forward_cuda``), ms
  a call and M poses/s, beside B1's bound;
* ``synthesis`` -- the synthesis body (``synthesize_dataset.synth_pairs``:
  B3, B1, world to camera, projection) at each of ``--synth_batches``
  (8192 to 65536), ms a batch and M poses/s;
* ``gan_steps`` -- one ``critics_step`` and one ``generator_step`` at the
  production shapes (batch 1024, nets 1000 wide, flip on), and a
  pipelined run of ``--pipelined`` iterations (critics every iteration,
  the generator every 5th), ms an iteration.

On the card every time comes from CUDA events around a loop of calls after
warm-up (``utils/profiling.cuda_time_ms``); with ``--device cpu`` from the
host clock (a CPU rehearsal, not a device number).

    python -m dhaug_torch.bench_components
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.bench import device_record, gan_setup, synthesis_batch
from dhaug_torch.ops import fk as fk_plain
from dhaug_torch.ops import fk_cuda
from dhaug_torch.utils.profiling import bound_ms, cuda_time_ms, fence


def time_ms(fn, device: torch.device, iters: int, warmup: int = 3) -> float:
    """ms a call of ``fn``: CUDA events on the card, the host clock around
    synchronized calls on the CPU."""
    if device.type == "cuda":
        return cuda_time_ms(fn, iters=iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def fk_inputs(B: int, device, seed: int = 0):
    """Angles uniform in +-90 deg, bone lengths in [0.1, 0.7] m, Euler
    rotation in +-180 deg, root ~ N(0, 1) (scripts/bench_components.py:40-44)."""
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(-90, 90, (B, 33)), rng.uniform(0.1, 0.7, (B, 15)),
              rng.uniform(-180, 180, (B, 3)), rng.normal(size=(B, 3)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]


def bench_fk(B: int, device: torch.device, iters: int) -> dict:
    """The plain FK against B1 at B poses (B1 only on the card)."""
    ang, bl, grot, root = fk_inputs(B, device)
    with torch.no_grad():
        plain = time_ms(lambda: fk_plain.fk_world_pose_16(ang, bl, grot, root), device, iters)
    out = {"component": "fk", "B": B, "plain_ms": plain, "plain_M_poses_per_s": B / plain / 1e3}
    if device.type == "cuda":
        kernel = time_ms(lambda: fk_cuda.fk_forward_cuda(ang, bl, grot, root), device, iters)
        err = float((fk_cuda.fk_forward_cuda(ang, bl, grot, root)
                     - fk_plain.fk_world_pose_16(ang, bl, grot, root)).abs().max())
        bound, by = bound_ms(B * (33 + 15 + 3 + 3 + 48) * 4, B * fk_cuda.FWD_FLOP_PER_POSE)
        out.update(kernel_ms=kernel, kernel_M_poses_per_s=B / kernel / 1e3,
                   plain_over_kernel=plain / kernel, kernel_max_abs_err_m=err,
                   bound_ms=bound, bound_by=by)
    return out


def bench_synthesis_body(batches, dense: int, device: torch.device, iters: int) -> list:
    """The synthesis body (``dhaug_torch.bench.synthesis_batch``) at each
    batch size."""
    batch = synthesis_batch(dense, device)
    rows = []
    for B in batches:
        ms = time_ms(lambda: batch(B), device, iters)
        rows.append({"component": "synthesis", "B": B, "ms": ms,
                     "M_poses_per_s": B / ms / 1e3})
    return rows


def bench_gan_steps(B: int, dense: int, device: torch.device, iters: int,
                    pipelined: int) -> dict:
    """One critics_step and one generator_step at batch B, and ``pipelined``
    iterations back to back (scripts/bench_components.py:100-136)."""
    steps, rows, t2d = gan_setup(B, B, dense, device)
    real, cam16 = rows.poses_3d, rows.cams
    g = torch.Generator(device=device)
    g.manual_seed(1)
    out = {}
    critics_ms = time_ms(lambda: out.update(c=steps.critics_step(real, cam16, t2d, g)),
                         device, iters)
    cam_idx, bone_len = out["c"][:2]
    gen_ms = time_ms(lambda: steps.generator_step(bone_len, cam_idx, g), device, iters)

    def run_epoch_like():
        for i in range(pipelined):
            cam_i, bl, *_ = steps.critics_step(real, cam16, t2d, g)
            if i % 5 == 4:
                steps.generator_step(bl, cam_i, g)
        fence(device)

    run_epoch_like()  # warm-up
    t0 = time.perf_counter()
    run_epoch_like()
    per_iter = (time.perf_counter() - t0) / pipelined * 1e3
    return {"component": "gan_steps", "B": B, "dense": dense, "critics_step_ms": critics_ms,
            "generator_step_ms": gen_ms, "pipelined_iters": pipelined,
            "pipelined_ms_per_iter": per_iter, "poses_judged_per_s": 1e3 / per_iter * B}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--fk_batch", type=int, default=65536)
    ap.add_argument("--synth_batches", default="8192,16384,32768,65536")
    ap.add_argument("--dense", type=int, default=1000)
    ap.add_argument("--gan_batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20, help="timed calls of each component")
    ap.add_argument("--pipelined", type=int, default=50)
    args = ap.parse_args(argv)
    device = dhaug_torch.resolve_device(args.device)
    record = device_record(device)
    lines = [bench_fk(args.fk_batch, device, args.iters)]
    lines += bench_synthesis_body([int(b) for b in args.synth_batches.split(",")], args.dense,
                                  device, args.iters)
    lines.append(bench_gan_steps(args.gan_batch, args.dense, device, args.iters,
                                 args.pipelined))
    for line in lines:
        print(json.dumps({**line, "device": record}), flush=True)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
