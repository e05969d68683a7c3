"""Posenet checkpoint evaluation on H36M S9/S11 and MPI-INF-3DHP on PyTorch.

Port of ``run_evaluate.py``.  It reads the
checkpoints of both port CLIs ('state_dict' from ``run_baseline``,
'model_pos' from ``run_fk_gan``, and a full-state snapshot's 'pos_state'),
the JAX package's posenet checkpoints under either key (flax trees of numpy
arrays, read without running pickled code) and reference
``ckpt_*.pth.tar`` files under either key; the posenet name comes from the
checkpoint where it holds one, else from ``--posenet_name``.
H36M is scored unflipped and 3DHP flip-averaged; ``--action-wise`` (on by
default) adds the H36M P1 of each action, and ``--Path_3DPW <npz>``
(``pose3d`` (N, 24|16, 3) metres, ``pose2d`` (N, 16, 2) normalized) a
flip-averaged 3DPW score: SMPL-24 joints are mapped to the H36M-16 layout
(``data/pw3d.py``) and P1/P2 taken over the 14 mapped joints after
mean-centring.  Checkpoints of the multi-frame ``mulit_farme_*`` posenets
(``--architecture`` must match the run's) are scored as video mode scores
them: the evaluation twin on whole edge-padded sequences, each sequence
weighted once (VideoPose), or on centre-frame windows weighted by frame
(PoseFormer), and ``--action-wise`` regroups those sequences by action;
their 3DPW score is the flip-averaged centre-frame prediction of each
frame's receptive-field window over the edge-padded flat npz (it carries no
sequence boundaries, so a window may straddle one).

    python -m dhaug_torch.run_evaluate --evaluate checkpoint/.../ckpt_best.ckpt \\
        --posenet_name videopose
    python -m dhaug_torch.run_evaluate --evaluate .../ckpt_best_h36m_p1.ckpt \\
        --posenet_name mulit_farme_videopose --architecture 3,3

``--evaluate`` also takes a ``--ckpt_format orbax`` directory of either
training CLI.  Runs on one device, as the JAX CLI does (it reads no
parallelism flag), on CUDA unless ``--device cpu`` is given; ``--device
cuda`` without a card raises.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.data.pw3d import PW3D_TO_16POINTS_TABLE, convert_to_16
from dhaug_torch.models.factory import make_posenet
from dhaug_torch.ops.metrics import mpjpe, p_mpjpe
from dhaug_torch.train.config import parse_baseline_args
from dhaug_torch.train.data_prep import prepare_data
from dhaug_torch.train.posenet import evaluate, evaluate_both, predict
from dhaug_torch.train.video_runner import (evaluate_video, per_action_eval_loaders,
                                           video_data_preparation)
from dhaug_torch.utils.checkpoint import load_posenet_checkpoint, resolve_posenet_weights


def score_3dpw(model, path: str, batch_size: int, rf: Optional[int] = None) -> dict:
    """P1/P2 (mm) of flip-averaged predictions on a 3DPW-style npz.  A
    multi-frame posenet (receptive field ``rf``; None for the others) sees
    each frame's window of the flat 2D edge-padded by ``rf // 2`` a side,
    in batches of ``batch_size`` windows (the index list edge-padded to
    whole batches, as the JAX CLI does), and its centre frame is scored."""
    data = np.load(path)
    gt3d, in2d = np.asarray(data["pose3d"], np.float32), np.asarray(data["pose2d"], np.float32)
    if gt3d.shape[1] == 24:
        gt3d = convert_to_16(gt3d, PW3D_TO_16POINTS_TABLE)
        mapped = sorted(PW3D_TO_16POINTS_TABLE.values())
    else:
        mapped = list(range(16))
    n = in2d.shape[0]
    if rf is not None:
        sel = np.minimum(np.arange(-(-n // batch_size) * batch_size), n - 1)
        padded = np.pad(in2d, ((rf // 2, rf // 2), (0, 0), (0, 0)), "edge")
        in2d = padded[sel[:, None] + np.arange(rf)[None]]     # (whole batches, rf, 16, 2)
    pred = predict(model, in2d, batch_size, flip=True)
    if rf is not None:
        pred = pred[:n, 0]                                    # (., 1, 16, 3): centre frame
    pred = pred[:, mapped]
    gt = torch.as_tensor(gt3d[:, mapped], device=pred.device)
    pred = pred - pred.mean(dim=1, keepdim=True)
    gt = gt - gt.mean(dim=1, keepdim=True)
    return {"p1": float(mpjpe(pred, gt)) * 1000.0, "p2": float(p_mpjpe(pred, gt)) * 1000.0,
            "joints": len(mapped), "frames": gt.shape[0]}


def main(argv=None) -> dict:
    """Evaluate; returns the H36M and 3DHP scores, and the 3DPW and
    per-action ones where asked for."""
    args = parse_baseline_args(argv)
    if not args.evaluate:
        raise SystemExit("--evaluate <ckpt path> is required")
    device = dhaug_torch.resolve_device(args.device)
    ckpt = load_posenet_checkpoint(args.evaluate)
    args.posenet_name = str(ckpt.get("posenet_name", args.posenet_name))
    video = args.posenet_name.startswith("mulit_farme")

    print("==> Loading dataset...")
    if video:
        args.single_or_multi_train_mode = "multi"
        bundle, _, h36m_eval, mpi3d_eval, rf = video_data_preparation(args)
    else:
        bundle, rf = prepare_data(args), None
    model = make_posenet(args.posenet_name, stages=args.stages, dropout=args.dropout,
                         architecture=args.architecture, skeleton=bundle.dataset.skeleton(),
                         flag="test").to(device)
    resolve_posenet_weights(ckpt, model, args.posenet_name)

    if video:
        h36m = evaluate_video(model, h36m_eval, args.batch_size, device)
        dhp = evaluate_video(model, mpi3d_eval, args.batch_size, device, flip=True)
    else:
        h36m, dhp = evaluate_both(model, bundle, args.batch_size)
    print(f"H36M  : P1 {h36m['p1']:.2f} mm | P2 {h36m['p2']:.2f} mm")
    print(f"3DHP  : P1 {dhp['p1']:.2f} mm | P2 {dhp['p2']:.2f} mm "
          f"| PCK {dhp['pck']:.2f} | AUC {dhp['auc']:.2f}")
    result = {"h36m": h36m, "dhp": dhp, "posenet_name": args.posenet_name}

    if args.Path_3DPW:
        pw3d = score_3dpw(model, args.Path_3DPW, args.batch_size, rf)
        print(f"3DPW  : P1 {pw3d['p1']:.2f} mm | P2 {pw3d['p2']:.2f} mm "
              f"({pw3d['joints']}-joint protocol, {pw3d['frames']} frames)")
        result["pw3d"] = pw3d

    if args.action_wise:
        print("H36M per-action P1 (mm):")
        result["actions"] = {}
        if video:
            groups = ((action, evaluate_video(model, loader, args.batch_size, device))
                      for action, loader in per_action_eval_loaders(args.batch_size, h36m_eval,
                                                                    (rf - 1) // 2))
        else:
            actions = np.asarray(bundle.actions_valid)
            groups = ((action, evaluate(model, bundle.h36m_test.poses_2d[actions == action],
                                        bundle.h36m_test.poses_3d[actions == action],
                                        args.batch_size))
                      for action in sorted(set(actions.tolist())))
        for action, m in groups:
            print(f"  {action:14s} {m['p1']:7.2f}")
            result["actions"][action] = m["p1"]
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
