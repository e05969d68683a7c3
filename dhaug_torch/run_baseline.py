"""Baseline posenet training (no augmentation) on PyTorch.

Port of ``run_baseline.py:22-199``: trains a single-frame posenet (``mlp``,
``gcn`` or ``videopose``) on the real H36M 2D->3D pairs with the
step-decayed Adam schedule and evaluates on H36M S9/S11 and MPI-INF-3DHP
every epoch.

* ``--train_npz <npz>`` (the DH-3DHP workflow): the ``pose3d``/``pose2d``
  pairs that ``python -m dhaug_torch.synthesize_dataset`` writes are mixed
  into the real training pairs (``--train_npz_mode mix``, the default) or
  trained on alone (``replace``); evaluation stays on the real sets.
* ``--pretrain true --evaluate <ckpt>`` warm-starts from a posenet
  checkpoint of either port CLI or a reference ``.pth.tar``.

It writes ``ckpt_best.ckpt`` (best H36M P1), ``ckpt_best_dhp_p1.ckpt`` and
every ``--snapshot`` epochs ``ckpt_epoch_%04d.ckpt``, each with the posenet
under 'state_dict'; ``log.txt`` and ``metrics.jsonl``; and last the line
``Best H36M P1: ... mm | best 3DHP P1: ... mm``, after drawing ``log.png``
from ``log.txt`` (``utils/viz.plot_metric_curves``); where the plot fails,
for example without matplotlib, it prints why and the run goes on, as the
JAX CLI does.

    python -m dhaug_torch.run_baseline --posenet_name videopose --keypoints gt \\
        --epochs 50 --batch_size 1024

Runs on CUDA unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.  ``--data_parallel_devices D --model_parallel_devices M``
trains on a grid of D x M ranks, one process a device, as ``run_fk_gan``
does (``parallel/mesh.py``, ``parallel/tensor.py``); global rank 0 writes
every file, in the single-device layout.  ``--ckpt_format orbax`` writes
each checkpoint as a ``ckpt_<suffix>/`` directory (``utils/checkpoint.py``).
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.models.factory import make_posenet
from dhaug_torch.parallel import mesh
from dhaug_torch.parallel.tensor import full_state_dict, shard_module_tp
from dhaug_torch.train.config import parse_baseline_args
from dhaug_torch.train.data_prep import prepare_data
from dhaug_torch.train.posenet import evaluate_both, train_epoch
from dhaug_torch.train.runners import make_logger, make_run_dir
from dhaug_torch.train.state import adam_posenet, set_learning_rate, step_exp_lr
from dhaug_torch.utils.checkpoint import (load_posenet_checkpoint, resolve_posenet_weights,
                                          save_snapshot)
from dhaug_torch.utils.viz import plot_metric_curves


def training_pairs(args, bundle):
    """The (2D, 3D) training arrays: the real split, or with
    ``--train_npz`` the synthesized pairs mixed in or alone."""
    real2d, real3d = bundle.train_det2d3d.poses_2d, bundle.train_det2d3d.poses_3d
    if not args.train_npz:
        return real2d, real3d
    synth = np.load(args.train_npz)
    for key in ("pose3d", "pose2d"):
        if key not in synth:
            raise SystemExit(f"--train_npz {args.train_npz} is missing '{key}' "
                             "(expected a synthesize_dataset output)")
    s2d = synth["pose2d"].astype(np.float32)
    s3d = synth["pose3d"].astype(np.float32)
    if args.train_npz_mode == "mix":
        print(f"==> Mixing {s3d.shape[0]} synthesized poses into {real2d.shape[0]} real "
              f"training pairs ({args.train_npz})")
        s2d, s3d = np.concatenate([real2d, s2d]), np.concatenate([real3d, s3d])
    else:
        print(f"==> Training on synthesized dataset {args.train_npz} ALONE: "
              f"{s3d.shape[0]} poses")
    if s3d.shape[0] < args.batch_size:
        raise SystemExit(
            f"--train_npz {args.train_npz} ({args.train_npz_mode}) yields only "
            f"{s3d.shape[0]} poses < --batch_size {args.batch_size}: zero training steps "
            "per epoch. Synthesize more poses or lower --batch_size.")
    return s2d, s3d


def main(argv=None) -> dict:
    """Train; returns the best H36M and 3DHP P1 (mm), the run directory,
    the per-epoch wall seconds and the trained posenet (with
    ``--data_parallel_devices N``, rank 0's, and ``rank_launches``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_baseline_args(argv)
    if args.pretrain and not args.evaluate:
        raise SystemExit("--pretrain true requires --evaluate <posenet checkpoint>")
    launched = mesh.launch_from_args(args, "dhaug_torch.run_baseline", argv)
    if launched is not None:
        return launched
    dp = mesh.current()
    device = dp.device if dp.device is not None else dhaug_torch.resolve_device(args.device)

    np_rng = np.random.default_rng(args.random_seed)
    torch.manual_seed(args.random_seed)  # weight initialisation
    generator = torch.Generator(device=device)
    generator.manual_seed(args.random_seed)

    print("==> Loading dataset...")
    bundle = prepare_data(args)

    print(f"==> Creating model: {args.posenet_name}")
    model = make_posenet(args.posenet_name, stages=args.stages, dropout=args.dropout,
                         architecture=args.architecture,
                         skeleton=bundle.dataset.skeleton()).to(device)
    print(f"==> Total parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    if args.pretrain:
        resolve_posenet_weights(load_posenet_checkpoint(args.evaluate), model,
                                args.posenet_name)
        print(f"==> Pretrained posenet loaded from {args.evaluate} (warm-start fine-tuning)")
    shard_module_tp(model)
    dp.broadcast_modules(model)

    opt = adam_posenet(model.parameters(), args.lr)
    max_norm = 1.0 if args.max_norm else 1e9
    poses_2d, poses_3d = training_pairs(args, bundle)
    dev2d = torch.as_tensor(poses_2d, device=device)
    dev3d = torch.as_tensor(poses_3d, device=device)

    run_dir = make_run_dir(args)
    print(f"==> Saving to {run_dir}")
    logger, summary = make_logger(run_dir, args)

    steps_per_epoch = dev2d.shape[0] // args.batch_size
    best_h36m = None
    best_dhp = None
    epoch_seconds = []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        global_step = epoch * steps_per_epoch
        lr_now = step_exp_lr(args.lr, (global_step // args.lr_decay) * args.lr_decay,
                             args.lr_decay, args.lr_gamma)
        set_learning_rate(opt, lr_now)
        loss = train_epoch(model, opt, dev2d, dev3d, np_rng, args.batch_size, max_norm,
                           generator, args.flip_pos_model_input)
        h36m, dhp = evaluate_both(model, bundle, args.batch_size)
        logger.append([epoch + 1, lr_now, h36m["p1"], h36m["p2"],
                       dhp["p1"], dhp["p2"], dhp["pck"], dhp["auc"]])
        for tag, val in [("h36m_p1", h36m["p1"]), ("h36m_p2", h36m["p2"]),
                         ("dhp_p1", dhp["p1"]), ("dhp_pck", dhp["pck"])]:
            summary.writer.add_scalar(f"posenet/{tag}", val, epoch)

        ckpt = lambda: {"epoch": epoch + 1, "lr": lr_now, "error": h36m["p1"],
                        "state_dict": full_state_dict(model), "posenet_name": args.posenet_name}
        if best_h36m is None or h36m["p1"] < best_h36m:
            best_h36m = h36m["p1"]
            save_snapshot(ckpt(), run_dir, suffix="best", fmt=args.ckpt_format)
        if best_dhp is None or dhp["p1"] < best_dhp:
            best_dhp = dhp["p1"]
            save_snapshot(ckpt(), run_dir, suffix="best_dhp_p1", fmt=args.ckpt_format)
        if (epoch + 1) % max(args.snapshot, 1) == 0:
            save_snapshot(ckpt(), run_dir, suffix="epoch_{:04d}".format(epoch + 1),
                          fmt=args.ckpt_format)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_seconds.append(time.perf_counter() - t0)
        print(f"Epoch {epoch}: lr {lr_now:.2e} loss {loss:.5f} "
              f"| H36M P1 {h36m['p1']:.2f} P2 {h36m['p2']:.2f} "
              f"| 3DHP P1 {dhp['p1']:.2f} PCK {dhp['pck']:.2f} AUC {dhp['auc']:.2f} "
              f"| {epoch_seconds[-1]:.2f} s")
        summary.epoch += 1

    logger.close()
    summary.close()
    # final metric-curve plot (the reference dumps log.eps, run_baseline.py:70-71)
    if dp.is_main:
        try:
            plot_metric_curves(os.path.join(run_dir, "log.txt"),
                               os.path.join(run_dir, "log.png"))
        except Exception as exc:  # plotting must never fail a training run
            print(f"(metric plot skipped: {exc})")
    print(f"Best H36M P1: {best_h36m:.2f} mm | best 3DHP P1: {best_dhp:.2f} mm")
    return {"best_h36m": best_h36m, "best_dhp": best_dhp, "run_dir": run_dir,
            "epoch_seconds": epoch_seconds, "posenet": model}


if __name__ == "__main__":
    main(sys.argv[1:])
