"""A/B of the generator update's FK: kernel B2 against autograd through the
plain FK, inside the single-frame GAN epoch on the card.

Port of ``scripts/bench_fk_grad_ab.py``.  Two arms run the same GAN epoch
(``dhaug_torch.bench.gan_epoch_runner``: ``run_gan_epoch`` over ``--scan``
batches of ``--batch`` seeded rows, nets ``--dense`` wide, flip on) from
the same weights and seeds:

* ``kernel_grad`` -- the port as it trains: the generator update's FK runs
  through ``ops/fk_cuda.FkFunction`` (B1 forward, B2 backward);
* ``plain_grad`` -- the generator update's FK runs the plain PyTorch FK
  (``ops/fk.py``) on the card, differentiated by autograd.  This arm is the
  only place where the port runs the plain FK on the card in training, and
  only for this comparison.

The critic phase's fakes, made without gradient, run B1 in both arms, so
the A/B isolates the gradient path.  The arms' timed epochs are
interleaved in one process (a warm-up epoch each first), each ended by a
synchronize; the median epoch gives ms/iter.  The arms start from the
same weights and draws, but B2 and autograd round the generator's
gradient differently (within 1e-5: ``chip_smoke.py``'s kernels phase holds
B2 to autograd), and Adam turns such differences into steps of ~lr, so
the arms' trajectories drift apart over the epochs: their epochs' mean
Wasserstein estimates are printed side by side, not held.

    python -m dhaug_torch.bench_fk_grad_ab [--iters 4] [--scan 40]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import torch

import dhaug_torch
from dhaug_torch.bench import device_record, gan_epoch_runner
from dhaug_torch.ops import fk as fk_plain
from dhaug_torch.ops import fk_cuda


@contextlib.contextmanager
def plain_fk_gradient():
    """Within the block, an FK call that needs a gradient runs the plain
    FK under autograd; one that needs none still launches B1."""
    kernel_route = fk_cuda.fk_world_pose_16

    def route(angles, bone_len, global_rot, root):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (angles, bone_len, global_rot, root)):
            return fk_plain.fk_world_pose_16(angles, bone_len, global_rot, root)
        return kernel_route(angles, bone_len, global_rot, root)

    fk_cuda.fk_world_pose_16 = route
    try:
        yield
    finally:
        fk_cuda.fk_world_pose_16 = kernel_route


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", default=4, type=int, help="timed epochs an arm")
    ap.add_argument("--scan", default=40, type=int, help="GAN iterations an epoch")
    ap.add_argument("--batch", default=1024, type=int)
    ap.add_argument("--dense", default=1000, type=int)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    device = dhaug_torch.resolve_device(args.device)
    record = device_record(device)
    print(f"device={record} B={args.batch} dense={args.dense} scan={args.scan}", flush=True)

    arms = {}
    for name, route in (("plain_grad", plain_fk_gradient),
                        ("kernel_grad", contextlib.nullcontext)):
        epoch, summary = gan_epoch_runner(args.batch, args.scan, args.dense, device)
        arms[name] = (epoch, summary, route)

    def run(name):
        epoch, _, route = arms[name]
        n0 = (fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES)
        with route():
            t0 = time.perf_counter()
            epoch()
            seconds = time.perf_counter() - t0
        return seconds, {"fwd": fk_cuda.FWD_LAUNCHES - n0[0], "bwd": fk_cuda.BWD_LAUNCHES - n0[1]}

    for name in arms:
        seconds, _ = run(name)  # warm-up
        print(f"{name}: warm-up epoch {seconds:.2f} s", flush=True)
    times = {name: [] for name in arms}
    launches = {}
    for _ in range(args.iters):
        for name in arms:  # interleaved
            seconds, launches[name] = run(name)
            times[name].append(seconds)

    w3d = {name: arms[name][1].epoch_scalar_history["3d_wasserstein"] for name in arms}
    diffs = [abs(a - b) for a, b in zip(w3d["plain_grad"], w3d["kernel_grad"])]
    for a, b, d in zip(w3d["plain_grad"], w3d["kernel_grad"], diffs):
        print(f"w3d plain={a:+.6f} kernel={b:+.6f} diff={d:.2e}")
    per = {name: statistics.median(ts) / args.scan for name, ts in times.items()}
    result = {"ab": "generator-update FK: B2 vs autograd through the plain FK",
              "batch": args.batch, "dense": args.dense, "scan": args.scan,
              **{f"{name}_ms_per_iter": per[name] * 1e3 for name in arms},
              **{f"{name}_epoch_times_s": times[name] for name in arms},
              "speedup_kernel_vs_plain": per["plain_grad"] / per["kernel_grad"],
              "launches_per_epoch": launches, "w3d_max_abs_diff": max(diffs),
              "device": record}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
