"""Benchmark of the port on one card: the JAX package's three lines.

Port of ``bench.py``: ``python -m dhaug_torch.bench [--check]`` prints
three JSON lines, in the JAX order:

1. video GAN training iterations/s (``bench_video_gan.measure``: the video
   GAN epoch at batch 512, receptive field 9, every net 1000 wide, the
   motion critics on);
2. single-frame GAN training iterations/s (``gan/single_frame.py::
   run_gan_epoch`` over ``--gan_scan`` batches of ``--gan_batch`` seeded
   rows, flip on, the nets' states threaded through ``--gan_iters`` timed
   epochs after one warm-up epoch; the median epoch gives ms/iter);
3. augmented poses/s: the synthesis body (``synthesize_dataset.synth_pairs``
   over ``parallel/sharded.py``'s body: noise -> trunk kernel B3 -> bone
   scalers -> FK kernel B1 -> world to camera -> distorted projection
   through S1's first camera) for ``--scan_steps`` batches of ``--batch``
   poses a call, every output reduced into one sum; the host clock around
   a call ended by a synchronize, the median over ``--iters`` calls after
   one warm-up call.  This line comes last and holds exactly ``metric``,
   ``value``, ``unit`` and ``vs_baseline``.

The lines before the last carry ``device`` (the card's name and power
limit, from nvidia-smi), ``ms_per_iter`` and three MFU figures against the
H100's fp32 peak of 67 TFLOP/s (TF32 is off, so the critics' GEMMs run as
fp32 SIMT, not on the tensor cores): ``mfu_est`` = ``mfu_lower_bound``
from the hand counts (``cost_analysis.gan_iter_flops`` /
``video_iter_flops``, dense layers only) and ``mfu_counted`` from
``cost_analysis``'s ``FlopCounterMode`` count of the same steps at the
line's shapes (the FK kernels' work not counted).

``vs_baseline`` divides each line by ``bench_reference_torch``'s rate for
the same mode (reference-style PyTorch: sequential-bmm FK, per-critic
loops), measured in this process on the same device at the line's own
batch size, ``--baseline_iters`` timed iterations after one warm-up.

The constants of the JAX file are flags here; the defaults reproduce its
shapes (``--batch 65536 --scan_steps 64 --dense 1000 --iters 5
--gan_batch 1024 --gan_scan 80 --gan_iters 3``, the video line 80 batches
a rep, 3 reps).  Runs on CUDA unless ``--device cpu`` is given: without a
card a plain run exits 1 naming the missing card, and ``--check`` exits 2
before any work (its bands are H100 measurements).  ``--check`` holds the
three lines to ``CHECK_NOMINALS`` (see there) and exits 1 on a regression,
with its verdict on stderr, so stdout stays JSON lines only.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

import dhaug_torch
from dhaug_torch import bench_reference_torch, bench_video_gan, cost_analysis
from dhaug_torch.data.loaders import PoseDataset, PoseTarget
from dhaug_torch.gan.single_frame import build_gan, run_gan_epoch
from dhaug_torch.gan.wgan import camera_bank, tiled_cam16
from dhaug_torch.models.generator import GeneratorConfig, FkGeneratorNet
from dhaug_torch.models.trunk_cuda import trunk_weights
from dhaug_torch.ops.fk import CANONICAL_BONE_LEN
from dhaug_torch.parallel.sharded import make_sharded_synthesizer
from dhaug_torch.synthesize_dataset import synth_pairs
from dhaug_torch.train.data_prep import train_subject_list
from dhaug_torch.utils.log import Summary
from dhaug_torch.utils.profiling import PEAK_FP32_FLOP_S, device_name, fence, nvidia_smi

VIDEO_FRAMES = bench_video_gan.FRAMES
MFU_PEAK = "67 TFLOP/s fp32 (H100 SXM; TF32 off, so the GEMMs run fp32 SIMT)"

# --check bands: this port's H100 measurements, the mean of two calls of
# ``python -m dhaug_torch.bench`` at its defaults on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §5: synthesis 19.76 / 19.52 M poses/s, GAN
# 19.64 / 22.10 iterations/s, video 3.59 / 3.72 iterations/s).  Each line
# is checked raw against a band wider than the spread between calls.  No
# in-process control divides them: the single-frame line is part
# host-bound (its iteration 64-86% busy on the card) and part
# device-bound, so neither a host control (the launch loop's host µs) nor
# a device control cancels its drift without over-correcting the other
# part.  Host seconds vary up to 2x between runs on the H100 host: the
# single-frame iteration took 45.2-58.7 ms across calls (26% slower than
# the fastest at worst), the video iteration 269.1-331.0 ms (23%); the
# synthesis line is device-bound (B3 and B1 at 65536 rows) and moved 1.2%.
CHECK_NOMINALS = {
    "synthesis_poses_per_sec": 19.64e6,
    "gan_iters_per_sec": 20.87,
    "video_iters_per_sec": 3.65,
}
CHECK_TOLERANCE = {"synthesis": 0.25, "gan": 0.30, "video": 0.25}


def check_regression(results: dict, nominals: dict = None, tol: dict = None) -> list:
    """Compare one bench run against the nominal bands; return a list of
    human-readable failure strings (empty = pass).  ``results`` is
    :func:`main`'s return value: {"video": line or None, "gan": line,
    "synthesis": line}; a line fails when its value is below ``(1 - tol)``
    of its nominal."""
    nominals = nominals or CHECK_NOMINALS
    tol = tol or CHECK_TOLERANCE
    failures = []
    for key, nom_key, name in (("synthesis", "synthesis_poses_per_sec", "synthesis poses/s"),
                               ("gan", "gan_iters_per_sec", "gan iters/s"),
                               ("video", "video_iters_per_sec", "video iters/s")):
        line = results.get(key)
        if not line:
            continue
        floor = nominals[nom_key] * (1.0 - tol[key])
        if line["value"] < floor:
            failures.append(f"{name}: {line['value']:.2f} < {floor:.2f} "
                            f"({(1 - tol[key]) * 100:.0f}% of nominal {nominals[nom_key]:.2f})")
    return failures


def device_record(device: torch.device) -> dict:
    """The device a line ran on: the card's name and nvidia-smi's name and
    power limit, or the CPU."""
    return {"name": device_name(device),
            "nvidia_smi": nvidia_smi() if device.type == "cuda" else None}


def _mfu(flops: float, per_sec: float) -> float:
    return flops * per_sec / PEAK_FP32_FLOP_S


def synthesis_batch(dense: int, device: torch.device):
    """``batch(B) -> (cam3d, pose2d, intrinsics)``: one batch of the
    synthesis body (``synthesize_dataset.synth_pairs``: noise -> trunk
    kernel B3 -> bone scalers -> FK kernel B1 -> world to camera ->
    distorted projection) at B poses of canonical bone lengths, through
    S1's first camera, for a generator ``dense`` wide (torch seed 0)."""
    cfg = GeneratorConfig(dense_dim=dense)
    torch.manual_seed(0)
    ops = trunk_weights(FkGeneratorNet(cfg).to(device))
    synthesize = make_sharded_synthesizer(cfg)
    cameras = camera_bank(["S1"], device)
    cam0 = torch.zeros((), dtype=torch.long, device=device)
    canonical = torch.as_tensor(CANONICAL_BONE_LEN, dtype=torch.float32, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(0)

    def batch(B: int):
        bone_len = canonical.expand(B, 15).contiguous()
        return synth_pairs(synthesize, ops, bone_len, cameras, g, cam_idx=cam0)

    return batch


def bench_synthesis(opts, device: torch.device) -> dict:
    """Poses/s of the synthesis body at ``--batch`` poses a batch,
    ``--scan_steps`` batches a call."""
    batch = synthesis_batch(opts.dense, device)

    def call():
        total = torch.zeros((), device=device)
        for _ in range(opts.scan_steps):
            cam3d, pose2d, _ = batch(opts.batch)
            # every output element feeds the sum
            total += cam3d.mean() + pose2d.mean()
        fence(device)
        return total

    call()  # warm-up
    times = []
    for _ in range(opts.iters):
        t0 = time.perf_counter()
        total = call()
        times.append(time.perf_counter() - t0)
    if not torch.isfinite(total):
        raise RuntimeError(f"synthesis produced a non-finite sum {float(total)}")
    return {"poses_per_sec": opts.batch * opts.scan_steps / statistics.median(times),
            "times_s": times}


def gan_setup(batch: int, n_rows: int, dense: int, device: torch.device):
    """(steps, rows, target_2d): the single-frame GAN (``build_gan``, flip
    on, every net ``dense`` wide, torch seed 0) and ``n_rows`` seeded
    N(0, 0.3) camera-space 3D poses and 2D targets on ``device``, seen
    through S1's first camera (``bench.py:293-303``)."""
    args = cost_analysis.gan_args(batch, dense, device.type)
    assert args.flip_GAN_model_input
    torch.manual_seed(0)
    steps = build_gan(args, train_subject_list(args), device)
    rng = np.random.default_rng(0)
    quats, trans, intrs = camera_bank(["S1"])
    real3d = torch.as_tensor(rng.normal(size=(n_rows, 16, 3)).astype(np.float32) * 0.3,
                             device=device)
    t2d = torch.as_tensor(rng.normal(size=(n_rows, 16, 2)).astype(np.float32) * 0.3,
                          device=device)
    rows = PoseDataset(real3d, t2d, tiled_cam16(intrs[0], quats[0], trans[0], n_rows, device))
    return steps, rows, t2d


def gan_epoch_runner(batch: int, scan: int, dense: int, device: torch.device):
    """(epoch, summary): ``epoch()`` runs ``gan/single_frame.py::
    run_gan_epoch`` over ``scan`` batches of ``batch`` rows of
    :func:`gan_setup` (critics every iteration with the gradient penalty
    and flip duplication, the generator every 5th) and synchronizes.  The
    nets are updated in place, so their states thread through the epochs as
    the training loop's do; ``summary`` keeps the epochs' scalars."""
    steps, rows, t2d = gan_setup(batch, scan * batch, dense, device)
    np_rng = np.random.default_rng(1)
    generator = torch.Generator(device=device)
    generator.manual_seed(1)
    summary = Summary(None)

    def epoch():
        run_gan_epoch(steps, rows, PoseTarget(t2d), PoseTarget(rows.poses_3d), batch, np_rng,
                      generator, summary)
        fence(device)

    return epoch, summary


def bench_gan_training(opts, device: torch.device) -> dict:
    """The single-frame GAN epoch's iterations/s: one warm-up epoch of
    ``--gan_scan`` iterations at ``--gan_batch``, then ``--gan_iters``
    timed epochs; the median epoch gives ms/iter."""
    epoch, summary = gan_epoch_runner(opts.gan_batch, opts.gan_scan, opts.dense, device)
    epoch()  # warm-up
    times = []
    for _ in range(opts.gan_iters):
        t0 = time.perf_counter()
        epoch()
        times.append(time.perf_counter() - t0)
    w3d = summary.epoch_scalar_history["3d_wasserstein"]
    if not all(np.isfinite(w3d)):
        raise RuntimeError(f"GAN epochs gave non-finite Wasserstein estimates {w3d}")
    per_iter = statistics.median(times) / opts.gan_scan
    return {"iters_per_sec": 1.0 / per_iter, "ms_per_iter": per_iter * 1e3, "times_s": times}


def gan_line(opts, device: torch.device, record: dict) -> dict:
    r = bench_gan_training(opts, device)
    ips = r["iters_per_sec"]
    base = bench_reference_torch.measure("gan_iter", opts.gan_batch, opts.baseline_iters,
                                         opts.dense, device)
    hand = cost_analysis.gan_iter_flops(opts.gan_batch, opts.dense)
    critics, gen = cost_analysis.count_steps(opts.gan_batch, opts.dense, device)
    counted = critics + gen / 5.0
    return {
        "metric": f"GAN training iterations/s (pipelined critics+GP+gen, batch {opts.gan_batch})",
        "value": ips, "unit": "iters/s", "vs_baseline": ips / base["value"],
        "ms_per_iter": r["ms_per_iter"], "epoch_times_s": r["times_s"],
        "mfu_est": _mfu(hand, ips), "mfu_lower_bound": _mfu(hand, ips),
        "mfu_counted": _mfu(counted, ips), "hand_gflops_per_iter": hand / 1e9,
        "counted_gflops_per_iter": counted / 1e9, "mfu_peak": MFU_PEAK,
        "baseline_iters_per_sec": base["value"], "device": record}


def video_line(opts, device: torch.device, record: dict) -> dict:
    v = bench_video_gan.measure(opts.video_batches, opts.video_reps, device, opts.video_batch,
                                opts.dense, verbose=False)
    ips = v["iters_per_sec"]
    base = bench_reference_torch.measure("video_gan_iter", opts.video_batch,
                                         opts.baseline_iters, opts.dense, device)
    hand = cost_analysis.video_iter_flops(opts.video_batch, VIDEO_FRAMES, opts.dense)
    critics, gen = cost_analysis.count_steps(opts.video_batch, opts.dense, device, video=True,
                                             frames=VIDEO_FRAMES)
    counted = critics + gen / 5.0
    return {
        "metric": "video GAN training iterations/s (5-model 12-update block, "
                  f"flip+playback+motion, batch {opts.video_batch}, rf {VIDEO_FRAMES})",
        "value": ips, "unit": "iters/s", "vs_baseline": ips / base["value"],
        "ms_per_iter": v["ms_per_iter"], "epoch_times_s": v["times_s"],
        "mfu_est": _mfu(hand, ips), "mfu_lower_bound": _mfu(hand, ips),
        "mfu_counted": _mfu(counted, ips), "hand_gflops_per_iter": hand / 1e9,
        "counted_gflops_per_iter": counted / 1e9, "mfu_peak": MFU_PEAK,
        "baseline_iters_per_sec": base["value"], "device": record}


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="hold the three lines to CHECK_NOMINALS (needs a card)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--batch", type=int, default=65536, help="synthesis poses a batch")
    ap.add_argument("--scan_steps", type=int, default=64, help="synthesis batches a call")
    ap.add_argument("--dense", type=int, default=1000, help="every net's width")
    ap.add_argument("--iters", type=int, default=5, help="timed synthesis calls")
    ap.add_argument("--gan_batch", type=int, default=1024)
    ap.add_argument("--gan_scan", type=int, default=80, help="GAN iterations an epoch")
    ap.add_argument("--gan_iters", type=int, default=3, help="timed GAN epochs")
    ap.add_argument("--video_batch", type=int, default=512, help="clips a video batch")
    ap.add_argument("--video_batches", type=int, default=80, help="video iterations an epoch")
    ap.add_argument("--video_reps", type=int, default=3, help="timed video epochs")
    ap.add_argument("--baseline_iters", type=int, default=10,
                    help="timed iterations of each reference-style baseline")
    return ap


def main(argv=None) -> dict:
    """Measure and print the three lines; returns {"video", "gan",
    "synthesis"}."""
    opts = get_parser().parse_args(argv)
    if opts.check and not (opts.device.startswith("cuda") and torch.cuda.is_available()):
        print("dhaug_torch.bench --check needs an NVIDIA card (the CHECK_NOMINALS bands are "
              "H100 measurements); run without --check for a plain measurement",
              file=sys.stderr)
        sys.exit(2)
    try:
        device = dhaug_torch.resolve_device(opts.device)
    except RuntimeError as exc:
        sys.exit(f"dhaug_torch.bench: {exc}")
    record = device_record(device)

    video = video_line(opts, device, record)
    print(json.dumps(video), flush=True)
    gan = gan_line(opts, device, record)
    print(json.dumps(gan), flush=True)
    syn = bench_synthesis(opts, device)
    base = bench_reference_torch.measure("synthesis", opts.batch, opts.baseline_iters,
                                         opts.dense, device)
    pps = syn["poses_per_sec"]
    print(f"synthesis on {record['nvidia_smi'] or 'cpu'}: {pps:.1f} poses/s (calls "
          f"{[round(t, 6) for t in syn['times_s']]} s of {opts.scan_steps} x {opts.batch}); "
          f"reference-style baseline {base['value']:.1f} poses/s at batch {opts.batch}",
          file=sys.stderr, flush=True)
    result = {"metric": "augmented poses/sec/chip (FK-GAN sampling)", "value": pps,
              "unit": "poses/s", "vs_baseline": pps / base["value"]}
    print(json.dumps(result), flush=True)
    out = {"video": video, "gan": gan, "synthesis": result}
    if opts.check:
        fails = check_regression(out)
        if fails:
            print("PERF REGRESSION:\n  " + "\n  ".join(fails), file=sys.stderr)
            sys.exit(1)
        print("perf check OK: every line within its band (raw values, tolerances "
              f"{CHECK_TOLERANCE})", file=sys.stderr)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
