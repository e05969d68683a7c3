"""Video-mode GAN training-iteration benchmark on the card.

Port of ``scripts/bench_video_gan.py``.  One iteration is the video GAN
epoch's per-batch work (``gan/video.py::run_video_gan_epoch``): the
12-critic-update block (single-frame 3D/2D critics and the motion critics,
flip AND playback duplication, the gradient penalty's double backward in
every update) plus the every-5th generator update over all four critics,
at the reference's video production config (batch 512, receptive field 9,
every net 1000 wide, the motion critics on; README.md:102).  B1 makes the
clip batch's B x F fakes every iteration, B1 and B2 run the generator
update's FK.

Protocol: the nets come from ``gan/video.py::build_video_gan``; a seeded
full-window clip loader (``data/chunked.ChunkWindows``) holds ``n_batches``
batches of clips over seeded random poses; one warm-up epoch, then ``reps``
timed epochs, each ended by a synchronize, the nets' states threaded
through all of them.  The median rep gives the rate.

    python -m dhaug_torch.bench_video_gan [--n_batches 80 --reps 3]

Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.cost_analysis import gan_args
from dhaug_torch.data.chunked import ChunkWindows
from dhaug_torch.gan.video import build_video_gan, run_video_gan_epoch
from dhaug_torch.gan.wgan import camera_bank, tiled_cam16
from dhaug_torch.train.data_prep import train_subject_list
from dhaug_torch.utils.log import Summary
from dhaug_torch.utils.profiling import fence

FRAMES = 9   # --architecture 3,3


def clip_loader(n_batches: int, batch: int, seed: int = 0, frames: int = FRAMES) -> ChunkWindows:
    """A shuffled loader of exactly ``n_batches`` batches of full
    ``frames``-frame windows: one sequence of ``n_batches * batch`` frames
    of N(0, 0.3) 3D and 2D poses, edge-padded, seen through S1's first
    camera."""
    rng = np.random.default_rng(seed)
    T = n_batches * batch
    pose3d = rng.normal(size=(T, 16, 3)).astype(np.float32) * 0.3
    pose2d = rng.normal(size=(T, 16, 2)).astype(np.float32) * 0.3
    quats, trans, intrs = camera_bank(["S1"])
    cam = tiled_cam16(intrs[0], quats[0], trans[0], 1)[0].numpy()
    return ChunkWindows(batch, [cam], [pose3d], [pose2d], pad=(frames - 1) // 2,
                        full_3d_window=True, shuffle=True, random_seed=seed)


def measure(n_batches: int = 80, reps: int = 3, device="cuda", batch: int = 512,
            dense: int = 1000, verbose: bool = True) -> dict:
    """The video GAN epoch's per-iteration cost: {"iters_per_sec",
    "ms_per_iter", "times_s"} from the median of ``reps`` epochs of
    ``n_batches`` iterations (after one warm-up epoch).  Also imported by
    ``dhaug_torch.bench`` for its video line."""
    say = print if verbose else (lambda *a, **k: None)
    device = dhaug_torch.resolve_device(str(device))
    torch.manual_seed(0)
    args = gan_args(batch, dense, device.type, video=True)
    gan = build_video_gan(args, train_subject_list(args), FRAMES, device)
    loader = clip_loader(n_batches, batch)
    generator = torch.Generator(device=device)
    generator.manual_seed(1)
    summary = Summary(None)

    def epoch():
        out = run_video_gan_epoch(gan, loader, batch, generator, summary, use_motion=True)
        fence(device)
        return summary.epoch_scalar_history["Fk_d3d_Wasserstein_D"][-1], out

    say(f"warm-up (B={batch}, F={FRAMES}, {n_batches} iters an epoch)...", flush=True)
    t0 = time.perf_counter()
    w, _ = epoch()
    say(f"  first epoch {time.perf_counter() - t0:.1f} s (w3d={w:.4f})", flush=True)
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        w, _ = epoch()
        dt = time.perf_counter() - t0
        times.append(dt)
        say(f"  rep {rep}: {dt * 1000:.0f} ms for {n_batches} iters -> {n_batches / dt:.2f} "
            f"iters/s ({dt / n_batches * 1000:.1f} ms/iter), w3d={w:.4f}", flush=True)
    # median, as bench.py's other lines
    mid = statistics.median(times)
    return {"iters_per_sec": n_batches / mid, "ms_per_iter": mid / n_batches * 1000.0,
            "times_s": times}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_batches", type=int, default=80)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--dense", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    r = measure(args.n_batches, args.reps, args.device, args.batch, args.dense)
    print(f"video GAN training iteration (B={args.batch}, F={FRAMES}, flip+playback+motion): "
          f"{r['iters_per_sec']:.2f} iters/s ({r['ms_per_iter']:.1f} ms/iter)", flush=True)
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
