"""Video-mode (multi-frame) FK-GAN training on PyTorch: data, the epoch
loop, evaluation.

Port of ``dhaug_tpu/train/video_runner.py`` (the reference's
vedio_multi_frame_mode_main, run_Fk_GAN.py:191-318, and the plumbing of
video_mode_operate.py), for the ``mulit_farme_videopose`` and
``mulit_farme_poseformer`` posenets.  Each epoch:

1. re-skin every training sequence with one random bone-length template and
   rebuild the GAN's full-window clip loader (``video_reskin_update``);
2. the video GAN epoch (``gan/video.py``), its motion critics on from epoch
   ``--single_dis_warmup_epoch``;
3. after ``--warmup`` + ``--single_dis_warmup_epoch`` epochs: the posenet
   pass on the fake clips (full-clip 2D in, centre-frame 3D target), an
   evaluation ('_fake'), the pass on real windows, an evaluation ('_real'),
   and the LR step (linear, then x ``--additional_LR_decay``);
4. the best-posenet checkpoints and, every ``--snapshot`` epochs, the
   full-state snapshot of the six nets that ``--resume`` continues from.

Evaluation runs the posenet's evaluation twin (the dilated VideoPose on
whole edge-padded sequences, sequence-weighted; PoseFormer on centre-frame
windows, frame-weighted) with the training weights.  The numpy stream is
consumed as the JAX package consumes it: each epoch one template index per
training sequence, the clip loader's seed, the fake pass's permutation and
the real pass's.  With ``--record_all_picture`` each GAN epoch dumps a fake
clip (3D and 2D) and a real re-skinned clip under ``<run dir>/tmp/``, and
the run ends with the GAN's epoch-mean curves.

Under data parallelism (``parallel/mesh.py``) each rank trains on its rows
of every batch of clips and windows, the windowed evaluation flavour
shards its batches over the ranks, the whole-sequence one runs whole on
every rank (dhaug_tpu/train/video_runner.py:262), and global rank 0 writes
the checkpoints, snapshots and pictures.  Under tensor parallelism the
five GAN nets, the posenet and its evaluation twin hold column blocks of
their wide layers (``parallel/tensor.py``).
"""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np
import torch

from dhaug_torch.data.chunked import ChunkWindows, UnchunkedSequences, split_mpi3d_sequences
from dhaug_torch.data.loaders import fetch
from dhaug_torch.gan.single_frame import reskin_rows
from dhaug_torch.gan.video import build_video_gan, run_video_gan_epoch
from dhaug_torch.models.factory import make_posenet, receptive_field
from dhaug_torch.parallel import mesh
from dhaug_torch.parallel.tensor import full_state_dict, shard_module_tp
from dhaug_torch.train.data_prep import prepare_data
from dhaug_torch.train.posenet import (evaluate_batches, evaluate_sequences,
                                       train_video_clips, train_video_windows)
from dhaug_torch.train.runners import make_logger, make_run_dir, write_eval_scalars
from dhaug_torch.train.state import adam_posenet, lambda_lr, set_learning_rate
from dhaug_torch.utils.checkpoint import (generator_state, load_snapshot, net_state,
                                          restore_generator, restore_net, save_ckpt,
                                          save_snapshot)
from dhaug_torch.utils.profiling import span, spanned
from dhaug_torch.utils.viz import plot_scalar_curves, plot_video_strip

def video_data_preparation(args):
    """The training windows, the H36M and 3DHP evaluation loaders and the
    receptive field (video_mode_operate.py:417-528).  Returns (bundle,
    train_loader, h36m_eval, mpi3d_eval, rf)."""
    bundle = prepare_data(args, per_frame_cam=False)
    rf = receptive_field(args.architecture)
    pad = (rf - 1) // 2
    train_loader = ChunkWindows(args.batch_size, bundle.cams_train, bundle.poses_train,
                                bundle.poses_train_2d, pad=pad, full_3d_window=False,
                                shuffle=True, random_seed=args.random_seed)

    # H36M: whole sequences for the dilated net, centre-frame windows for
    # the others (video_mode_operate.py:470-481)
    pv, pv2, cams_v, acts = fetch(bundle.subjects_test, bundle.dataset, bundle.keypoints,
                                  bundle.action_filter, stride=args.downsample, train=False,
                                  with_extrinsics=False, per_frame_cam=False)
    whole = args.posenet_name == "mulit_farme_videopose"
    if whole:
        h36m_eval = UnchunkedSequences(cams_v, pv, pv2, pad=pad)
    else:
        h36m_eval = ChunkWindows(args.batch_size, cams_v, pv, pv2, pad=pad,
                                 full_3d_window=False, shuffle=False, drop_last=False)
    # the per-action breakdown regroups these very sequences
    # (per_action_eval_loaders)
    h36m_eval.eval_sequences = (cams_v, pv, pv2, [a[0] for a in acts])

    mpi = np.load(os.path.join(args.data_root, "data_extra", "test_set", "test_3dhp.npz"))
    seq3d, seq2d = split_mpi3d_sequences(mpi["pose3d"], mpi["pose2d"])
    if whole:
        mpi3d_eval = UnchunkedSequences([np.zeros(1)] * len(seq3d), seq3d, seq2d, pad=pad)
    else:
        mpi3d_eval = ChunkWindows(args.batch_size, None, seq3d, seq2d, pad=pad,
                                  full_3d_window=False, shuffle=False, drop_last=False)
    return bundle, train_loader, h36m_eval, mpi3d_eval, rf


def per_action_eval_loaders(batch_size: int, h36m_eval, pad: int):
    """(action, loader) pairs over the H36M evaluation sequences of
    ``video_data_preparation``, grouped by action, each loader of the same
    kind as the headline one."""
    cams_v, pv, pv2, seq_act = h36m_eval.eval_sequences
    whole = isinstance(h36m_eval, UnchunkedSequences)
    for action in sorted(set(seq_act)):
        idx = [i for i, a in enumerate(seq_act) if a == action]
        cams, p3, p2 = [cams_v[i] for i in idx], [pv[i] for i in idx], [pv2[i] for i in idx]
        if whole:
            yield action, UnchunkedSequences(cams, p3, p2, pad=pad)
        else:
            yield action, ChunkWindows(batch_size, cams, p3, p2, pad=pad, full_3d_window=False,
                                       shuffle=False, drop_last=False)


@torch.no_grad()
@spanned("reskin.update")
def video_reskin_update(args, bundle, templates: np.ndarray, rng: np.random.Generator,
                        device) -> ChunkWindows:
    """Re-skin each training sequence with one random bone-length template
    (one ``rng.integers`` a sequence), re-project it, and build the GAN's
    full-window clip loader seeded from ``rng`` (video_mode_operate.py:879-966)."""
    pad = (receptive_field(args.architecture) - 1) // 2
    lengths = [np.asarray(s).shape[0] for s in bundle.poses_train]
    tmpl_idx = [int(rng.integers(0, templates.shape[0])) for _ in lengths]

    with span("reskin.upload"):
        flat3d = torch.as_tensor(np.concatenate([np.asarray(s, np.float32)
                                                 for s in bundle.poses_train]), device=device)
        cams = torch.as_tensor(np.repeat(np.stack([np.asarray(c, np.float32)[:9]
                                                   for c in bundle.cams_train]), lengths,
                                         axis=0), device=device)
        rows = torch.as_tensor(templates, dtype=torch.float32, device=device)[
            torch.as_tensor(np.repeat(tmpl_idx, lengths), device=device)]
    with span("reskin.rows"):
        new3d, new2d = reskin_rows(flat3d, cams, rows)
    with span("reskin.download"):
        splits = np.cumsum(lengths)[:-1]
        new3d = np.split(new3d.cpu().numpy(), splits)
        new2d = np.split(new2d.cpu().numpy(), splits)
    with span("reskin.loader"):
        return ChunkWindows(args.batch_size, bundle.cams_train, new3d, new2d, pad=pad,
                            full_3d_window=True, shuffle=True,
                            random_seed=int(rng.integers(0, 2 ** 31)))


def video_eval_batches(loader, batch_size: int, device, bucket: int = 128):
    """(inputs_2d, targets_3d, valid) batches on ``device``: whole sequences
    edge-padded to a multiple of ``bucket`` frames (``valid`` drops the
    padding), or centre-frame windows in order, ``batch_size`` at a time."""
    if isinstance(loader, UnchunkedSequences):
        for _cam, seq3d, seq2d in loader.next_epoch():
            T = seq3d.shape[1]
            extra = -(-T // bucket) * bucket - T
            if extra:
                seq2d = np.pad(seq2d, ((0, 0), (0, extra), (0, 0), (0, 0)), "edge")
                seq3d = np.pad(seq3d, ((0, 0), (0, extra), (0, 0), (0, 0)), "edge")
            yield (torch.as_tensor(seq2d, device=device), torch.as_tensor(seq3d, device=device),
                   T)
        return
    big2d, big3d, _ = loader.device_arrays(device)
    start2d = torch.as_tensor(loader.start2d, device=device)
    idx3d = torch.as_tensor(loader.idx3d, device=device)
    win = torch.arange(loader.window, device=device)[None]
    for s in range(0, loader.n_chunks, batch_size):
        sel = slice(s, s + batch_size)
        yield big2d[start2d[sel][:, None] + win], big3d[idx3d[sel]][:, None]


def evaluate_video(eval_net, loader, batch_size: int, device, flip: bool = False) -> dict:
    """Whole sequences sequence-weighted, windows frame-weighted (sharded
    over the ranks of a data-parallel group)."""
    batches = video_eval_batches(loader, batch_size, device)
    if isinstance(loader, UnchunkedSequences):
        return evaluate_sequences(eval_net, batches, flip)
    return evaluate_batches(eval_net, batches, flip)


def video_mode_main(args, train_subjects: List[str], device) -> dict:
    """Run the training; returns what ``run_fk_gan.main`` returns, with the
    best scores and the numpy stream besides."""
    method = args.data_enhancement_method
    dp = mesh.current()
    np_rng = np.random.default_rng(args.random_seed)
    torch.manual_seed(args.random_seed)  # weight initialisation
    generator = torch.Generator(device=device)
    generator.manual_seed(args.random_seed)

    print("==> Loading dataset...")
    bundle, train_loader, h36m_eval, mpi3d_eval, rf = video_data_preparation(args)
    print(f"==> receptive field: {rf}")

    print("==> Creating PoseNet model...")
    kw = dict(stages=args.stages, dropout=args.dropout, architecture=args.architecture,
              skeleton=bundle.dataset.skeleton())
    posenet = make_posenet(args.posenet_name, flag="train", **kw).to(device)
    # evaluation runs the twin with the training weights (the same column
    # blocks under tensor parallelism)
    eval_net = make_posenet(args.posenet_name, flag="test", **kw).to(device)
    shard_module_tp(posenet)
    shard_module_tp(eval_net)
    pos_opt = adam_posenet(posenet.parameters(), args.lr_p)
    max_norm = 1.0 if args.max_norm else 1e9

    gan = build_video_gan(args, train_subjects, rf, device) if method == "GAN" else None
    dp.broadcast_modules(posenet, *([gan.gen, gan.d3d, gan.d2d, gan.md3d, gan.md2d]
                                    if gan is not None else []))

    run_dir = make_run_dir(args)
    print(f"==> Making checkpoint dir: {run_dir}")
    logger, summary = make_logger(run_dir, args)
    templates = np.load(os.path.join(args.data_root, "data_extra", "bone_length_npy",
                                     "hm36s15678_bl_templates.npy"))

    def eval_both():
        eval_net.load_state_dict(posenet.state_dict())
        return (evaluate_video(eval_net, h36m_eval, args.batch_size, device),
                evaluate_video(eval_net, mpi3d_eval, args.batch_size, device, flip=True))

    dhpp1_best = s911p1_best = None
    lr_now = args.lr_p
    trained_epochs = 0  # the LR schedule counts trained epochs only
    scores = {"h36m": {"p1": 0.0, "p2": 0.0},
              "dhp": {"p1": 0.0, "p2": 0.0, "pck": 0.0, "auc": 0.0}}
    start_epoch = 0
    warm = args.warmup + args.single_dis_warmup_epoch
    gan_epochs_end = args.epochs + warm
    total_epochs = gan_epochs_end + args.additional_train_epoch
    nets = {"pos_state": (posenet, pos_opt)}
    if gan is not None:
        nets.update({"gen_state": (gan.gen, gan.gen_opt), "d3d_state": (gan.d3d, gan.d3d_opt),
                     "d2d_state": (gan.d2d, gan.d2d_opt),
                     "md3d_state": (gan.md3d, gan.md3d_opt),
                     "md2d_state": (gan.md2d, gan.md2d_opt)})

    # full-state resume of the six nets, counters and random streams
    resume_path = args.resume or args.GAN_resume
    if resume_path:
        saved = load_snapshot(resume_path)
        for key, (net, opt) in nets.items():
            if key == "pos_state" or key in saved:
                restore_net(net, opt, saved[key])
        summary.load_state_dict(saved["summary"])
        np_rng.bit_generator.state = saved["np_rng"]
        start_epoch = int(saved["epoch"]) + 1
        summary.epoch = start_epoch  # the snapshot is taken pre-increment
        restore_generator(generator, saved["torch_rng"], device, args.random_seed + start_epoch)
        lr_now = float(saved["lr_now"])
        trained_epochs = int(saved["trained_epochs"])
        dhpp1_best = saved["dhpp1_best"]
        s911p1_best = saved["s911p1_best"]
        dp.broadcast_modules(*(net for net, _ in nets.values()))
        print(f"==> Resumed from {resume_path} at epoch {start_epoch}")

    def full_state_ckpt(now_epoch: int) -> dict:
        state = {"epoch": now_epoch, "lr_now": lr_now, "trained_epochs": trained_epochs,
                 "dhpp1_best": dhpp1_best, "s911p1_best": s911p1_best,
                 "summary": summary.state_dict(), "np_rng": np_rng.bit_generator.state,
                 "torch_rng": generator_state(generator, device)}
        state.update({key: net_state(net, opt) for key, (net, opt) in nets.items()})
        return state

    epoch_seconds = []
    for now_epoch in range(start_epoch, total_epochs):
        t0 = time.perf_counter()
        fakes = None
        if method == "GAN":
            gan_loader = video_reskin_update(args, bundle, templates, np_rng, device)
            use_motion = summary.epoch >= args.single_dis_warmup_epoch
            fakes = run_video_gan_epoch(gan, gan_loader, args.batch_size, generator, summary,
                                        use_motion, summary.writer)
        if args.record_all_picture and fakes is not None and dp.is_main:
            # the reference dumps real clips beside the fake ones
            # (video_GAN_fun.py:590-600)
            f3d, f2d, _ = fakes
            plot_video_strip(f3d[0].cpu().numpy(), f2d[0].cpu().numpy(),
                             os.path.join(run_dir, "tmp", f"fake_video_ep{summary.epoch}.jpg"),
                             title=f"fake clip, epoch {summary.epoch}")
            start = int(gan_loader.start3d[0])
            plot_video_strip(gan_loader.big3d[start:start + rf], None,
                             os.path.join(run_dir, "tmp", f"real_video_ep{summary.epoch}.jpg"),
                             title=f"real (re-skinned) clip, epoch {summary.epoch}")

        train_now = (summary.epoch > warm and method == "GAN") or method == "normal"
        if train_now:
            if fakes is not None:
                f3d, f2d, _ = fakes
                center = (rf - 1) // 2
                train_video_clips(posenet, pos_opt, f2d, f3d[:, center:center + 1], np_rng,
                                  args.batch_size, max_norm, generator,
                                  args.flip_pos_model_input, args.GAN_video_playback_input)
                h36m, dhp = eval_both()
                logger.append([summary.epoch, 0, h36m["p1"], h36m["p2"],
                               dhp["p1"], dhp["p2"], dhp["pck"], dhp["auc"]])
                write_eval_scalars(summary.writer, summary.epoch, h36m, dhp, "_fake")
                scores = {"h36m": h36m, "dhp": dhp}
            train_video_windows(posenet, pos_opt, train_loader, np_rng, args.batch_size,
                                max_norm, generator, args.flip_pos_model_input,
                                args.Pos_video_playback_input)
            h36m, dhp = eval_both()
            write_eval_scalars(summary.writer, summary.epoch, h36m, dhp, "_real")
            scores = {"h36m": h36m, "dhp": dhp}

            trained_epochs += 1
            # GAN mode runs the linear schedule until the GAN phase ends,
            # 'normal' until --epochs, then x --additional_LR_decay
            lr_end = gan_epochs_end if method == "GAN" else args.epochs
            if now_epoch < lr_end:
                lr_now = lambda_lr(args.lr_p, trained_epochs, args.epochs)
            else:
                lr_now = lr_now * args.additional_LR_decay
            set_learning_rate(pos_opt, max(lr_now, 0.0))

        h36m, dhp = scores["h36m"], scores["dhp"]
        logger.append([summary.epoch, lr_now, h36m["p1"], h36m["p2"], dhp["p1"], dhp["p2"],
                       dhp.get("pck", 0), dhp.get("auc", 0)])
        ckpt = lambda: {"epoch": summary.epoch, "model_pos": full_state_dict(posenet),
                        "posenet_name": args.posenet_name}
        if dhp["p1"] and (dhpp1_best is None or dhpp1_best > dhp["p1"]):
            dhpp1_best = dhp["p1"]
            save_ckpt(ckpt(), run_dir, suffix="best_dhp_p1")
        if h36m["p1"] and (s911p1_best is None or s911p1_best > h36m["p1"]):
            s911p1_best = h36m["p1"]
            save_ckpt(ckpt(), run_dir, suffix="best_h36m_p1")
        if (summary.epoch + 1) % max(args.snapshot, 1) == 0:
            save_snapshot(full_state_ckpt(now_epoch), run_dir, suffix="resume_latest",
                          fmt=args.ckpt_format)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_seconds.append(time.perf_counter() - t0)
        print(f"\nEpoch: {summary.epoch} | LR: {lr_now:.8f} | H36M P1 {h36m['p1']:.2f} "
              f"| 3DHP P1 {dhp['p1']:.2f} | {epoch_seconds[-1]:.2f} s")
        summary.epoch += 1

    if args.record_all_picture and summary.epoch_scalar_history and dp.is_main:
        plot_scalar_curves(summary.epoch_scalar_history,
                           os.path.join(run_dir, "wasserstein_curves.png"),
                           title="GAN critic curves (epoch means)")
    logger.close()
    summary.close()
    return {"scores": scores, "epoch_seconds": epoch_seconds,
            "epoch_scalars": summary.epoch_scalar_history, "run_dir": run_dir,
            "best_h36m": s911p1_best, "best_dhp": dhpp1_best, "gan": gan,
            "posenet": posenet, "pos_opt": pos_opt, "generator": generator, "np_rng": np_rng}
