"""Single-frame FK-GAN augmented posenet training on PyTorch.

Port of ``run_Fk_GAN.py:24-297``'s single-frame mode, for the posenets
``mlp``, ``gcn`` and ``videopose`` and the three augmentation methods:

* ``GAN``: each epoch re-skin the real training poses -> GAN epoch (critics
  every iteration, generator every 5th) -> posenet pass on the fakes (after
  ``--warmup`` epochs) -> evaluation ('_fake') -> posenet pass on the real
  data -> evaluation ('_real');
* ``normal``: each epoch ``--generator_whole_number`` random FK poses
  (``gan/traditional.py``) seen through every training camera -> posenet
  pass on them -> evaluation -> the real pass -> evaluation;
* ``NO_enhance``: the real pass and its evaluation only.

Then the LR step, the best-posenet checkpoints (``ckpt_best_dhp_p1.ckpt``,
``ckpt_best_h36m_p1.ckpt``) and, every ``--snapshot`` epochs, the full-state
``ckpt_resume_latest.ckpt`` that ``--resume`` (or ``--GAN_resume``)
continues from and ``python -m dhaug_torch.synthesize_dataset --ckpt``
samples from.  ``--pretrain true --evaluate <ckpt>`` trains nothing: it
hands the checkpoint to ``python -m dhaug_torch.run_evaluate``.

    python -m dhaug_torch.run_fk_gan --posenet_name mlp --lr_p 1e-3 \\
        --keypoints gt --batch_size 1024 \\
        --data_enhancement_method GAN --single_or_multi_train_mode single

Runs on CUDA unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.  Flags that need code not ported yet are refused with an error
(video mode and the ``mulit_farme_*`` posenets, ``--synthetic_data``,
``--bf16_trunk``, the orbax format, picture dumps, multi-device).  Besides
the checkpoints the run writes ``log.txt`` and ``metrics.jsonl``.

A snapshot resumes bit for bit on the device type that wrote it.  Resumed on
the other type, the weights, optimizer states and numpy stream carry over,
but the ``torch.Generator`` stream cannot (its state differs between CPU and
CUDA): it is seeded from ``--random_seed`` and the epoch instead.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.data.loaders import PoseDataset, PoseTarget
from dhaug_torch.gan.single_frame import build_gan, reskin_dataset, run_gan_epoch
from dhaug_torch.gan.traditional import (TraditionalConfig, generate_traditional_poses,
                                         project_through_cameras)
from dhaug_torch.gan.wgan import camera_bank
from dhaug_torch.models.factory import make_posenet
from dhaug_torch.train.config import parse_aug_args
from dhaug_torch.train.data_prep import prepare_data, train_subject_list, world_pose_pool
from dhaug_torch.train.posenet import evaluate_both, train_epoch
from dhaug_torch.train.runners import (make_logger, make_run_dir, refuse_unported,
                                       write_eval_scalars)
from dhaug_torch.train.state import adam_posenet, lambda_lr, set_learning_rate
from dhaug_torch.utils.checkpoint import load_snapshot, restore_into, save_ckpt, save_snapshot


def _pretrain_evaluate(args) -> dict:
    """``--pretrain true``: evaluate the posenet of ``--evaluate`` once and
    train nothing, through ``run_evaluate`` (run_Fk_GAN.py:270-297)."""
    from dhaug_torch import run_evaluate
    print("==> --pretrain true: evaluating the pretrained posenet (no training)")
    return run_evaluate.main([
        "--evaluate", args.evaluate, "--posenet_name", args.posenet_name,
        "--architecture", args.architecture, "--stages", str(args.stages),
        "--dropout", str(args.dropout), "--batch_size", str(args.batch_size),
        "--downsample", str(args.downsample), "--data_root", args.data_root,
        "--keypoints", args.keypoints, "--s1only", str(bool(args.s1only)).lower(),
        "--device", args.device])


def _net_state(net: torch.nn.Module, opt: torch.optim.Optimizer) -> dict:
    """A net and its optimizer, as a snapshot holds them."""
    return {"model": net.state_dict(), "opt": opt.state_dict()}


def _restore_net(net: torch.nn.Module, opt: torch.optim.Optimizer, saved: dict) -> None:
    restore_into(net, saved["model"])
    opt.load_state_dict(saved["opt"])


def main(argv=None) -> dict:
    """Run the training; returns the final scores, the per-epoch wall
    seconds, the per-epoch GAN scalars, the run directory, the trained GAN
    (None outside GAN mode), the posenet with its optimizer, and the
    torch.Generator.  With ``--pretrain true`` it returns what
    ``run_evaluate.main`` returns."""
    args = parse_aug_args(argv)
    if args.pretrain and not args.evaluate:
        raise SystemExit("--pretrain true requires --evaluate <posenet checkpoint>")
    refuse_unported(args)
    if args.pretrain:
        return _pretrain_evaluate(args)
    device = dhaug_torch.resolve_device(args.device)
    print(f"==> device {device}; TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    method = args.data_enhancement_method

    train_subjects = train_subject_list(args)
    print("==> Loading dataset...")
    bundle = prepare_data(args)

    np_rng = np.random.default_rng(args.random_seed)
    torch.manual_seed(args.random_seed)  # weight initialisation
    generator = torch.Generator(device=device)
    generator.manual_seed(args.random_seed)

    print("==> Creating PoseNet model...")
    posenet = make_posenet(args.posenet_name, stages=args.stages, dropout=args.dropout,
                           architecture=args.architecture,
                           skeleton=bundle.dataset.skeleton()).to(device)
    pos_opt = adam_posenet(posenet.parameters(), args.lr_p)
    max_norm = 1.0 if args.max_norm else 1e9
    real_2d = torch.as_tensor(bundle.train_det2d3d.poses_2d, device=device)
    real_3d = torch.as_tensor(bundle.train_det2d3d.poses_3d, device=device)

    gan = build_gan(args, train_subjects, device) if method == "GAN" else None

    run_dir = make_run_dir(args)
    print(f"==> Making checkpoint dir: {run_dir}")
    logger, summary = make_logger(run_dir, args)
    if method == "GAN":
        templates = np.load(os.path.join(args.data_root, "data_extra", "bone_length_npy",
                                         "hm36s15678_bl_templates.npy"))
    elif method == "normal":
        pose_pool = torch.as_tensor(world_pose_pool(bundle, seed=args.random_seed),
                                    device=device)
        cams = camera_bank(train_subjects, device)
        trad_cfg = TraditionalConfig(
            n_poses=args.generator_whole_number,
            use_dataset_bone_len=args.generator_choose_BoneLen,
            use_dataset_root=args.generator_choose_root_pos,
            use_global_rot=args.generator_global_rot,
            bone_len_scaler=args.bone_len_scaler)

    scores = {"h36m": {"p1": 0, "p2": 0}, "dhp": {"p1": 0, "p2": 0, "pck": 0, "auc": 0}}
    lr_now = 0.0
    dhpp1_best = None
    s911p1_best = None
    start_epoch = 0
    nets = {"pos_state": (posenet, pos_opt)}
    if gan is not None:
        nets.update({"gen_state": (gan.gen, gan.gen_opt), "d3d_state": (gan.d3d, gan.d3d_opt),
                     "d2d_state": (gan.d2d, gan.d2d_opt)})

    # full-state resume (run_Fk_GAN.py:96-116); a snapshot of another mode
    # lends the posenet (and the GAN where both have one)
    resume_path = args.resume or args.GAN_resume
    if resume_path:
        saved = load_snapshot(resume_path)
        for key, (net, opt) in nets.items():
            if key == "pos_state" or key in saved:
                _restore_net(net, opt, saved[key])
        summary.load_state_dict(saved["summary"])
        np_rng.bit_generator.state = saved["np_rng"]
        start_epoch = int(saved["epoch"]) + 1
        summary.epoch = start_epoch  # the snapshot is taken pre-increment
        if saved["torch_rng"]["device"] == device.type:
            generator.set_state(saved["torch_rng"]["state"])
        else:
            generator.manual_seed(args.random_seed + start_epoch)
            print(f"==> the snapshot's torch.Generator stream is for "
                  f"{saved['torch_rng']['device']}; reseeded for {device.type}")
        lr_now = float(saved["lr_now"])
        dhpp1_best = saved["dhpp1_best"]
        s911p1_best = saved["s911p1_best"]
        print(f"==> Resumed from {resume_path} at epoch {start_epoch}")

    def full_state_ckpt(now_epoch: int) -> dict:
        state = {"epoch": now_epoch, "lr_now": lr_now,
                 "dhpp1_best": dhpp1_best, "s911p1_best": s911p1_best,
                 "summary": summary.state_dict(), "np_rng": np_rng.bit_generator.state,
                 "torch_rng": {"device": device.type, "state": generator.get_state()}}
        state.update({key: _net_state(net, opt) for key, (net, opt) in nets.items()})
        return state

    epoch_seconds = []
    for now_epoch in range(start_epoch, args.epochs + args.additional_train_epoch):
        t0 = time.perf_counter()
        fake_ds = None
        if method == "GAN":
            gt2d3d = reskin_dataset(bundle.train_gt2d3d, templates, np_rng, device)
            fake_ds = run_gan_epoch(gan, gt2d3d, PoseTarget(gt2d3d.poses_2d),
                                    PoseTarget(gt2d3d.poses_3d), args.batch_size, np_rng,
                                    generator, summary, summary.writer)
        elif method == "normal":
            pose16, *_ = generate_traditional_poses(generator, pose_pool, trad_cfg)
            fake_ds = PoseDataset(*project_through_cameras(pose16, *cams), None)

        train_now = (summary.epoch > args.warmup and method == "GAN") or method == "normal"
        if train_now and fake_ds is not None:
            train_epoch(posenet, pos_opt, fake_ds.poses_2d, fake_ds.poses_3d, np_rng,
                        args.batch_size, max_norm, generator, args.flip_pos_model_input)
            h36m, dhp = evaluate_both(posenet, bundle, args.batch_size)
            logger.append([summary.epoch, 0, h36m["p1"], h36m["p2"],
                           dhp["p1"], dhp["p2"], dhp["pck"], dhp["auc"]])
            write_eval_scalars(summary.writer, summary.epoch, h36m, dhp, "_fake")
            scores = {"h36m": h36m, "dhp": dhp}
        if train_now or method == "NO_enhance":
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

        # best-posenet checkpoints (run_Fk_GAN.py:238-249); the state_dict
        # carries the BatchNorm running statistics
        ckpt = {"epoch": summary.epoch, "model_pos": posenet.state_dict(),
                "posenet_name": args.posenet_name}
        if dhp["p1"] and (dhpp1_best is None or dhpp1_best > dhp["p1"]):
            dhpp1_best = dhp["p1"]
            logger.record_args(f"==> Saving checkpoint at epoch '{summary.epoch}', "
                               f"with dhp_p1 {dhpp1_best}")
            save_ckpt(ckpt, run_dir, suffix="best_dhp_p1")
        if h36m["p1"] and (s911p1_best is None or s911p1_best > h36m["p1"]):
            s911p1_best = h36m["p1"]
            save_ckpt(ckpt, run_dir, suffix="best_h36m_p1")
        if (summary.epoch + 1) % max(args.snapshot, 1) == 0:
            save_snapshot(full_state_ckpt(now_epoch), run_dir, suffix="resume_latest",
                          fmt=args.ckpt_format)
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
            "gan": gan, "posenet": posenet, "pos_opt": pos_opt, "generator": generator}


if __name__ == "__main__":
    main(sys.argv[1:])
