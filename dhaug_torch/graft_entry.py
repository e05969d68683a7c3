"""Entry points: the flagship forward step, and a multi-rank dry run.

Counterpart of ``__graft_entry__.py``.

* :func:`entry` returns ``(forward, example_args)``: the FK-GAN generator
  pipeline (noise -> dense trunk -> DH forward kinematics -> 16-joint
  world poses (256, 16, 3)) on the card unless the caller asks for the CPU.
* :func:`dryrun_multichip` runs the production training programs on n gloo
  ranks of the CPU over a (data, model) grid (``parallel/mesh.launch``;
  model 2 when n is even): the single-frame GAN epoch
  (``gan/single_frame.run_gan_epoch``: critic updates with WGAN-GP, the
  every-5th generator update, fake buffering), a posenet epoch on its
  fakes (``train/posenet.train_epoch``) and the video GAN epoch
  (``gan/video.run_video_gan_epoch``: the 12-critic-update block of flip x
  playback x motion), each batch split over the data axis and every wide
  layer over the model axis -- what ``--data_parallel_devices`` /
  ``--model_parallel_devices`` run.  The batch is fixed, so a one-rank
  replay in this process runs the same programs from the same seeds; the
  grid's scalar metrics must equal the replay's within 5e-4 of
  max(1, |value|), the JAX file's tolerance.  The metrics held are each
  GAN epoch's first-iteration critic estimates and generator cost and the
  posenet epoch's loss.  The GAN epochs' means over later iterations are
  printed, not held: once a data axis splits the batch, cuBLAS/MKL sum a
  rank's rows in another order, and Adam turns a rounding-sized gradient
  into a step of ~lr, so the ranks and the replay drift apart from the
  first update (on 2 x 2 CPU ranks: 1e-7 at iteration 0, 3e-3 at
  iteration 2 of the single-frame epoch).

Importing the module starts no process.

    python -m dhaug_torch.graft_entry [--ranks 8] [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.bench_video_gan import clip_loader
from dhaug_torch.cost_analysis import gan_args
from dhaug_torch.data.loaders import PoseDataset, PoseTarget
from dhaug_torch.gan.single_frame import build_gan, run_gan_epoch
from dhaug_torch.gan.video import build_video_gan, run_video_gan_epoch
from dhaug_torch.gan.wgan import camera_bank, tiled_cam16
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig, synthesize_poses
from dhaug_torch.models.posenets import LinearModel
from dhaug_torch.ops.fk import CANONICAL_BONE_LEN
from dhaug_torch.parallel import mesh
from dhaug_torch.parallel.tensor import TP_MIN_WIDTH, shard_module_tp
from dhaug_torch.train.data_prep import train_subject_list
from dhaug_torch.train.posenet import train_epoch
from dhaug_torch.train.state import adam_posenet
from dhaug_torch.utils.log import Summary

# the narrowest width whose layers a model axis splits (parallel/tensor.py)
DRYRUN_DENSE = TP_MIN_WIDTH
DRYRUN_TOL = 5e-4


def entry(device="cuda"):
    """(forward, example_args): ``forward(net, noise, bone_len, scaler8)``
    -> world poses (B, 16, 3), with the generator 1000 wide (torch seed 0)
    and B = 256 rows of noise, canonical bone lengths and zero scalers on
    ``device``.  On the card the FK runs kernel B1 (B1/B2 under autograd)."""
    device = dhaug_torch.resolve_device(str(device))
    cfg = GeneratorConfig(dense_dim=1000)
    torch.manual_seed(0)
    net = FkGeneratorNet(cfg).to(device)

    def forward(net, noise, bone_len, scaler8):
        return synthesize_poses(net(noise), bone_len, scaler8, cfg)

    B = 256
    g = torch.Generator(device=device)
    g.manual_seed(1)
    example_args = (
        net,
        torch.randn((B, 128), generator=g, device=device),
        torch.as_tensor(CANONICAL_BONE_LEN, dtype=torch.float32,
                        device=device).expand(B, 15).contiguous(),
        torch.zeros((B, 8), device=device),
    )
    return forward, example_args


class _FirstValues:
    """A writer for the GAN epochs that keeps each scalar tag's first
    value (the epoch's first iteration; the generator cost's first
    update)."""

    def __init__(self):
        self.first = {}

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.first.setdefault(tag.rsplit("/", 1)[-1], float(value))


def run_programs(batch: int, dense: int = DRYRUN_DENSE) -> tuple:
    """The three production programs on this process's rank (or on one
    device outside a group), from fixed seeds, on the CPU: (the scalar
    metrics the dry run holds, the GAN epochs' means).  Every rank sees the
    same data and draws; the steps take each rank's rows of every batch."""
    device = torch.device("cpu")
    n_batches = 3
    rng = np.random.default_rng(0)
    quats, trans, intrs = camera_bank(["S1"])

    # 1) the single-frame GAN epoch: 3 iterations from iteration 4, so the
    #    generator update runs on the first
    torch.manual_seed(0)
    args = gan_args(batch, dense, "cpu")
    gan = build_gan(args, train_subject_list(args), device)
    N = n_batches * batch + 7
    real3d = torch.as_tensor(rng.normal(size=(N, 16, 3)).astype(np.float32) * 0.3)
    t2d = torch.as_tensor(rng.normal(size=(N, 16, 2)).astype(np.float32) * 0.3)
    rows = PoseDataset(real3d, t2d, tiled_cam16(intrs[0], quats[0], trans[0], N))
    np_rng = np.random.default_rng(1)
    generator = torch.Generator(device=device)
    generator.manual_seed(7)
    summary, first = Summary(None), _FirstValues()
    summary.train_iter_num = 4
    fakes = run_gan_epoch(gan, rows, PoseTarget(t2d), PoseTarget(real3d), batch, np_rng,
                          generator, summary, writer=first)
    metrics = {"3d_wasserstein": first.first["Fk_d3d_Wasserstein_D"],
               "2d_wasserstein": first.first["d2d_Wasserstein_D"],
               "g_cost": first.first["G_cost"]}
    means = {k: summary.epoch_scalar_history[k][-1]
             for k in ("3d_wasserstein", "2d_wasserstein", "g_cost")}

    # 2) a posenet epoch on the GAN's fakes
    torch.manual_seed(11)
    posenet = LinearModel(linear_size=dense, num_stage=1, p_dropout=0.25).to(device)
    shard_module_tp(posenet)
    opt = adam_posenet(posenet.parameters(), 1e-4)
    metrics["pos_loss"] = train_epoch(posenet, opt, fakes.poses_2d, fakes.poses_3d, np_rng,
                                      batch, 1.0, generator, flip=True)

    # 3) the video GAN epoch: 2 iterations of 3-frame clips from iteration
    #    4, flip + playback + motion (the full 12-critic-update block)
    torch.manual_seed(21)
    vargs = gan_args(batch, dense, "cpu", video=True)
    vgan = build_video_gan(vargs, train_subject_list(vargs), 3, device)
    vsummary, vfirst = Summary(None), _FirstValues()
    vsummary.train_iter_num = 4
    run_video_gan_epoch(vgan, clip_loader(2, batch, seed=2, frames=3), batch, generator,
                        vsummary, use_motion=True, writer=vfirst)
    for key, tag in (("video_w3d", "Fk_d3d_Wasserstein_D"),
                     ("video_motion_w2d", "motion_d2d_Wasserstein_D"),
                     ("video_g_cost", "G_cost")):
        metrics[key] = vfirst.first[tag]
        means[key] = vsummary.epoch_scalar_history[tag][-1]
    for name, v in {**metrics, **means}.items():
        if not np.isfinite(v):
            raise RuntimeError(f"dry run metric {name} is not finite: {v}")
    return metrics, means


def dryrun_multichip(n_devices: int) -> dict:
    """The three programs on ``n_devices`` gloo ranks of the CPU, on a
    (data, model) grid with model 2 when ``n_devices`` is even, then again
    on one device in this process; raises unless every held metric agrees
    within DRYRUN_TOL of max(1, |one-device value|).  Returns the grid's
    metrics, the replay's, the largest relative gap and the GAN epoch
    means' gaps."""
    model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    # fixed, so the one-device replay runs the same programs
    batch = 16 * max(1, n_devices // model)
    ranks = mesh.launch("dhaug_torch.graft_entry:run_programs", (batch,),
                        ["cpu"] * n_devices, "gloo", threads=1, model_parallel=model)
    metrics, means = ranks[0]
    print(f"dryrun_multichip({n_devices}): grid {n_devices // model} x {model} (data x model) "
          "OK; single-frame GAN epoch x3 + posenet epoch + video GAN epoch x2 "
          "(12-update block); metrics: "
          + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items()), flush=True)
    single, single_means = run_programs(batch)
    gap = lambda a, b: {k: abs(a[k] - b[k]) / max(1.0, abs(b[k])) for k in a}
    deltas, mean_deltas = gap(metrics, single), gap(means, single_means)
    worst = max(deltas, key=deltas.get)
    if not deltas[worst] <= DRYRUN_TOL:
        raise AssertionError(
            f"sharded vs single-device metric divergence: {worst} {metrics[worst]:.6f} (grid) "
            f"vs {single[worst]:.6f} (one device), rel delta {deltas[worst]:.2e} > {DRYRUN_TOL}")
    print(f"dryrun_multichip({n_devices}): sharded==single: OK (max rel delta "
          f"{deltas[worst]:.2e} on '{worst}', tol {DRYRUN_TOL}); the GAN epochs' means, not "
          f"held: max rel delta {max(mean_deltas.values()):.2e}", flush=True)
    return {"grid": metrics, "single": single, "max_rel_delta": deltas[worst],
            "epoch_mean_rel_deltas": mean_deltas}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=8, help="gloo ranks of the dry run")
    ap.add_argument("--device", default="cuda", help="the forward step's device")
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    with torch.no_grad():
        print("entry forward:", tuple(fn(*example).shape), flush=True)
    dryrun_multichip(args.ranks)


if __name__ == "__main__":
    main(sys.argv[1:])
