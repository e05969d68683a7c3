"""Single-frame FK-GAN augmented posenet training on PyTorch.

Port of ``run_Fk_GAN.py:24-263`` for the ``--data_enhancement_method GAN
--single_or_multi_train_mode single --posenet_name mlp`` branch.  Each epoch:
re-skin the real training poses -> GAN epoch (critics every iteration,
generator every 5th) -> posenet pass on the fakes -> evaluation ('_fake') ->
posenet pass on the real data -> evaluation ('_real') -> LR step.

    python -m dhaug_torch.run_fk_gan --posenet_name mlp --lr_p 1e-3 \\
        --keypoints gt --batch_size 1024 \\
        --data_enhancement_method GAN --single_or_multi_train_mode single

Runs on CUDA unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.  Flags that need code not ported yet are refused with an error
(other modes and posenets, resume, picture dumps, multi-device).  This slice
writes ``log.txt`` and ``metrics.jsonl`` but no checkpoints.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.data.loaders import PoseTarget
from dhaug_torch.gan.single_frame import build_gan, reskin_dataset, run_gan_epoch
from dhaug_torch.models.posenets import LinearModel
from dhaug_torch.train.config import parse_aug_args
from dhaug_torch.train.data_prep import prepare_data, train_subject_list
from dhaug_torch.train.posenet import evaluate_both, train_epoch
from dhaug_torch.train.runners import make_logger, make_run_dir, write_eval_scalars
from dhaug_torch.train.state import adam_posenet, lambda_lr, set_learning_rate


def _refuse_unported(args) -> None:
    unported = []
    if args.data_enhancement_method != "GAN":
        unported.append(f"--data_enhancement_method {args.data_enhancement_method}")
    if args.single_or_multi_train_mode != "single":
        unported.append(f"--single_or_multi_train_mode {args.single_or_multi_train_mode}")
    if args.posenet_name != "mlp":
        unported.append(f"--posenet_name {args.posenet_name}")
    for flag in ("resume", "GAN_resume", "evaluate"):
        if getattr(args, flag):
            unported.append(f"--{flag}")
    for flag in ("pretrain", "record_all_picture", "synthetic_data", "bf16_trunk"):
        if getattr(args, flag):
            unported.append(f"--{flag} true")
    if args.data_parallel_devices > 1 or args.model_parallel_devices > 1:
        unported.append("--data_parallel_devices/--model_parallel_devices above 1")
    if unported:
        raise NotImplementedError(
            "not ported yet to dhaug_torch: " + ", ".join(unported)
            + " (the JAX package's run_Fk_GAN.py has them)")


def main(argv=None) -> dict:
    """Run the training; returns the final scores, the per-epoch wall
    seconds, the per-epoch GAN scalars and the trained GAN."""
    args = parse_aug_args(argv)
    _refuse_unported(args)
    device = dhaug_torch.resolve_device(args.device)
    print(f"==> device {device}; TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    train_subjects = train_subject_list(args)
    print("==> Loading dataset...")
    bundle = prepare_data(args)

    np_rng = np.random.default_rng(args.random_seed)
    torch.manual_seed(args.random_seed)  # weight initialisation
    generator = torch.Generator(device=device)
    generator.manual_seed(args.random_seed)

    print("==> Creating PoseNet model...")
    posenet = LinearModel(num_stage=args.stages, p_dropout=args.dropout).to(device)
    pos_opt = adam_posenet(posenet.parameters(), args.lr_p)
    max_norm = 1.0 if args.max_norm else 1e9
    real_2d = torch.as_tensor(bundle.train_det2d3d.poses_2d, device=device)
    real_3d = torch.as_tensor(bundle.train_det2d3d.poses_3d, device=device)

    gan = build_gan(args, train_subjects, device)

    run_dir = make_run_dir(args)
    print(f"==> Making checkpoint dir: {run_dir}")
    logger, summary = make_logger(run_dir, args)
    templates = np.load(os.path.join(args.data_root, "data_extra", "bone_length_npy",
                                     "hm36s15678_bl_templates.npy"))

    scores = {"h36m": {"p1": 0, "p2": 0}, "dhp": {"p1": 0, "p2": 0, "pck": 0, "auc": 0}}
    lr_now = 0.0
    epoch_seconds = []
    for now_epoch in range(args.epochs + args.additional_train_epoch):
        t0 = time.perf_counter()
        gt2d3d = reskin_dataset(bundle.train_gt2d3d, templates, np_rng, device)
        fake_ds = run_gan_epoch(gan, gt2d3d, PoseTarget(gt2d3d.poses_2d),
                                PoseTarget(gt2d3d.poses_3d), args.batch_size, np_rng,
                                generator, summary, summary.writer)

        train_now = summary.epoch > args.warmup
        if train_now and fake_ds is not None:
            train_epoch(posenet, pos_opt, fake_ds.poses_2d, fake_ds.poses_3d, np_rng,
                        args.batch_size, max_norm, generator, args.flip_pos_model_input)
            h36m, dhp = evaluate_both(posenet, bundle, args.batch_size)
            logger.append([summary.epoch, 0, h36m["p1"], h36m["p2"],
                           dhp["p1"], dhp["p2"], dhp["pck"], dhp["auc"]])
            write_eval_scalars(summary.writer, summary.epoch, h36m, dhp, "_fake")
            scores = {"h36m": h36m, "dhp": dhp}
        if train_now:
            train_epoch(posenet, pos_opt, real_2d, real_3d, np_rng, args.batch_size,
                        max_norm, generator, args.flip_pos_model_input)
            h36m, dhp = evaluate_both(posenet, bundle, args.batch_size)
            write_eval_scalars(summary.writer, summary.epoch, h36m, dhp, "_real")
            scores = {"h36m": h36m, "dhp": dhp}

        # posenet LR: linear decay for args.epochs, then x additional_LR_decay
        if now_epoch < args.epochs:
            lr_now = lambda_lr(args.lr_p, now_epoch + 1, args.epochs)
        else:
            lr_now = lr_now * args.additional_LR_decay
        set_learning_rate(pos_opt, lr_now)
        h36m, dhp = scores["h36m"], scores["dhp"]
        logger.append([summary.epoch, lr_now, h36m["p1"], h36m["p2"], dhp["p1"], dhp["p2"],
                       dhp.get("pck", 0), dhp.get("auc", 0)])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_seconds.append(time.perf_counter() - t0)
        print(f"\nEpoch: {summary.epoch} | LR: {lr_now:.8f} | H36M P1 {h36m['p1']:.2f} "
              f"| 3DHP P1 {dhp['p1']:.2f} | {epoch_seconds[-1]:.2f} s")
        summary.epoch += 1

    logger.close()
    summary.close()
    return {"scores": scores, "epoch_seconds": epoch_seconds,
            "epoch_scalars": summary.epoch_scalar_history, "run_dir": run_dir,
            "gan": gan}


if __name__ == "__main__":
    main(sys.argv[1:])
