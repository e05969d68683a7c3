"""Per-phase wall clock of training epochs: where does an epoch's time go?

Port of ``scripts/profile_epoch.py``.  Runs the README's single-frame
command (``--posenet_name mlp --lr_p 1e-3 --keypoints gt --batch_size 1024
--data_enhancement_method GAN``, every net at full width) with
``--synthetic_data true --warmup 0``, or with ``--video`` the video-mode
command (``mulit_farme_videopose --architecture 3,3 --batch_size 512``, the
motion critics on from the first epoch), and prints each phase's seconds:

* single-frame: data prep, then each epoch's reskin, gan epoch, posenet
  fake pass, eval (fake), posenet real pass, eval (real), ckpt state fetch;
* video: video data prep, then each epoch's reskin + clip loader, video gan
  epoch, posenet fake pass, posenet real pass, eval (h36m + 3dhp), ckpt
  state fetch.

Each phase is one call of the piece the training loop runs
(``train/data_prep``, ``gan/single_frame``, ``train/posenet``,
``train/video_runner``, ``gan/video``), ended by a fence on the device
(``utils/profiling.fence``), so its seconds include the device work it
queued.  The checkpoint phase copies every net's ``state_dict`` to the
host.  The GAN phases launch the FK kernels B1 (every critic phase and
generator update) and B2 (every generator update) on the card; their
launch counts are printed last.

    python -m dhaug_torch.profile_epoch [--epochs 2]
    python -m dhaug_torch.profile_epoch --video --epochs 1
    python -m dhaug_torch.profile_epoch --device cpu --epochs 1

Runs on CUDA unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.  ``--data_root`` defaults to the working directory (the
repository's committed fixture when run from its root); ``--synthetic_data``
writes any missing fixture file there.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.data.loaders import PoseTarget
from dhaug_torch.gan.single_frame import build_gan, reskin_dataset, run_gan_epoch
from dhaug_torch.gan.video import build_video_gan, run_video_gan_epoch
from dhaug_torch.models.factory import make_posenet
from dhaug_torch.ops import fk_cuda
from dhaug_torch.train.config import parse_aug_args
from dhaug_torch.train.data_prep import prepare_data, train_subject_list
from dhaug_torch.train.posenet import (evaluate_both, train_epoch, train_video_clips,
                                       train_video_windows)
from dhaug_torch.train.state import adam_posenet
from dhaug_torch.train.video_runner import (evaluate_video, video_data_preparation,
                                            video_reskin_update)
from dhaug_torch.utils.log import Summary
from dhaug_torch.utils.profiling import fence

SINGLE_FRAME_PHASES = ("reskin", "gan epoch", "posenet fake pass", "eval (fake)",
                       "posenet real pass", "eval (real)", "ckpt state fetch")
VIDEO_PHASES = ("reskin + clip loader", "video gan epoch", "posenet fake pass",
                "posenet real pass", "eval (h36m + 3dhp)", "ckpt state fetch")


def profile_argv(video: bool, data_root: str, batch_size: int, device: str) -> list:
    """The fixed training command the profiler parses (``--batch_size`` 0:
    1024 single-frame, 512 video)."""
    common = ["--keypoints", "gt", "--epochs", "50", "--data_enhancement_method", "GAN",
              "--synthetic_data", "true", "--data_root", data_root, "--warmup", "0",
              "--device", device]
    if video:
        return common + ["--posenet_name", "mulit_farme_videopose", "--architecture", "3,3",
                         "--batch_size", str(batch_size or 512),
                         "--single_or_multi_train_mode", "multi",
                         "--single_dis_warmup_epoch", "0"]
    return common + ["--posenet_name", "mlp", "--lr_p", "1e-3",
                     "--batch_size", str(batch_size or 1024),
                     "--single_or_multi_train_mode", "single"]


class _Phases:
    """Times each phase to its device fence, prints it, keeps (name, s)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds = []

    def __call__(self, name: str, fn):
        t = time.perf_counter()
        out = fn()
        fence(self.device)
        seconds = time.perf_counter() - t
        print(f"{name:21s}: {seconds:7.2f} s", flush=True)
        self.seconds.append((name, seconds))
        return out


def host_state(nets: dict) -> dict:
    """Every net's ``state_dict`` copied to the host."""
    return {name: {k: v.detach().cpu() for k, v in net.state_dict().items()}
            for name, net in nets.items()}


def _launches(before: tuple) -> dict:
    return {"fwd": fk_cuda.FWD_LAUNCHES - before[0], "bwd": fk_cuda.BWD_LAUNCHES - before[1]}


def _templates(args) -> np.ndarray:
    return np.load(os.path.join(args.data_root, "data_extra", "bone_length_npy",
                                "hm36s15678_bl_templates.npy"))


def _streams(args, device):
    """The numpy stream, the weight initialisation seed and the device's
    ``torch.Generator``, seeded as ``run_fk_gan`` seeds them."""
    torch.manual_seed(args.random_seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.random_seed)
    return np.random.default_rng(args.random_seed), generator


def profile_single_frame(args, epochs: int, device: torch.device) -> dict:
    """``epochs`` single-frame GAN epochs, phase by phase.  Returns the
    phases' (name, seconds) in order, the B1/B2 launches, the nets and the
    last host copy of their states."""
    phase = _Phases(device)
    before = (fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES)
    bundle = phase("data prep", lambda: prepare_data(args))

    np_rng, generator = _streams(args, device)
    posenet = make_posenet(args.posenet_name, stages=args.stages, dropout=args.dropout,
                           architecture=args.architecture,
                           skeleton=bundle.dataset.skeleton()).to(device)
    pos_opt = adam_posenet(posenet.parameters(), args.lr_p)
    max_norm = 1.0 if args.max_norm else 1e9
    gan = build_gan(args, train_subject_list(args), device)
    nets = {"pos": posenet, "gen": gan.gen, "d3d": gan.d3d, "d2d": gan.d2d}
    summary = Summary(None)
    templates = _templates(args)
    real_2d = torch.as_tensor(bundle.train_det2d3d.poses_2d, device=device)
    real_3d = torch.as_tensor(bundle.train_det2d3d.poses_3d, device=device)

    def posenet_pass(poses_2d, poses_3d):
        return train_epoch(posenet, pos_opt, poses_2d, poses_3d, np_rng, args.batch_size,
                           max_norm, generator, args.flip_pos_model_input)

    state = None
    for epoch in range(epochs):
        print(f"--- epoch {epoch} ---")
        gt2d3d = phase("reskin", lambda: reskin_dataset(bundle.train_gt2d3d, templates,
                                                        np_rng, device))
        fake_ds = phase("gan epoch", lambda: run_gan_epoch(
            gan, gt2d3d, PoseTarget(gt2d3d.poses_2d), PoseTarget(gt2d3d.poses_3d),
            args.batch_size, np_rng, generator, summary))
        if fake_ds is not None:
            phase("posenet fake pass", lambda: posenet_pass(fake_ds.poses_2d, fake_ds.poses_3d))
            phase("eval (fake)", lambda: evaluate_both(posenet, bundle, args.batch_size))
            phase("posenet real pass", lambda: posenet_pass(real_2d, real_3d))
            phase("eval (real)", lambda: evaluate_both(posenet, bundle, args.batch_size))
        state = phase("ckpt state fetch", lambda: host_state(nets))
        summary.epoch += 1
    return {"phases": phase.seconds, "launches": _launches(before), "nets": nets,
            "state": state}


def profile_video(args, epochs: int, device: torch.device) -> dict:
    """``epochs`` video-mode GAN epochs with the motion critics on, phase
    by phase.  Returns what :func:`profile_single_frame` returns."""
    phase = _Phases(device)
    before = (fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES)
    bundle, train_loader, h36m_eval, mpi3d_eval, rf = phase(
        "video data prep", lambda: video_data_preparation(args))

    np_rng, generator = _streams(args, device)
    kw = dict(stages=args.stages, dropout=args.dropout, architecture=args.architecture,
              skeleton=bundle.dataset.skeleton())
    posenet = make_posenet(args.posenet_name, flag="train", **kw).to(device)
    eval_net = make_posenet(args.posenet_name, flag="test", **kw).to(device)
    pos_opt = adam_posenet(posenet.parameters(), args.lr_p)
    max_norm = 1.0 if args.max_norm else 1e9
    gan = build_video_gan(args, train_subject_list(args), rf, device)
    nets = {"pos": posenet, "gen": gan.gen, "d3d": gan.d3d, "d2d": gan.d2d,
            "md3d": gan.md3d, "md2d": gan.md2d}
    summary = Summary(None)
    templates = _templates(args)
    center = (rf - 1) // 2

    def eval_both():
        eval_net.load_state_dict(posenet.state_dict())
        return (evaluate_video(eval_net, h36m_eval, args.batch_size, device),
                evaluate_video(eval_net, mpi3d_eval, args.batch_size, device, flip=True))

    state = None
    for epoch in range(epochs):
        print(f"--- epoch {epoch} ---")
        gan_loader = phase("reskin + clip loader", lambda: video_reskin_update(
            args, bundle, templates, np_rng, device))
        fakes = phase("video gan epoch", lambda: run_video_gan_epoch(
            gan, gan_loader, args.batch_size, generator, summary, use_motion=True))
        summary.epoch += 1
        if fakes is not None:
            f3d, f2d, _ = fakes
            phase("posenet fake pass", lambda: train_video_clips(
                posenet, pos_opt, f2d, f3d[:, center:center + 1], np_rng, args.batch_size,
                max_norm, generator, args.flip_pos_model_input,
                args.GAN_video_playback_input))
        phase("posenet real pass", lambda: train_video_windows(
            posenet, pos_opt, train_loader, np_rng, args.batch_size, max_norm, generator,
            args.flip_pos_model_input, args.Pos_video_playback_input))
        phase("eval (h36m + 3dhp)", eval_both)
        state = phase("ckpt state fetch", lambda: host_state(nets))
    return {"phases": phase.seconds, "launches": _launches(before), "nets": nets,
            "state": state}


def main(argv=None) -> dict:
    """Profile; returns what :func:`profile_single_frame` or
    :func:`profile_video` returns."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default=".")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=0,
                    help="default 1024 single-frame / 512 video")
    ap.add_argument("--video", action="store_true",
                    help="profile the video-mode epoch (5-net GAN, clip posenet passes, "
                         "whole-sequence evaluation)")
    ap.add_argument("--device", default="cuda", type=str, help="cuda or cpu")
    opts = ap.parse_args(argv)
    args = parse_aug_args(profile_argv(opts.video, opts.data_root, opts.batch_size,
                                       opts.device))
    device = dhaug_torch.resolve_device(args.device)
    profile = profile_video if opts.video else profile_single_frame
    result = profile(args, opts.epochs, device)
    print(f"FK launches on {device}: B1 {result['launches']['fwd']}, "
          f"B2 {result['launches']['bwd']}", flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
