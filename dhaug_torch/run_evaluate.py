"""Posenet checkpoint evaluation on H36M S9/S11 and MPI-INF-3DHP on PyTorch.

Port of ``run_evaluate.py``'s single-frame branch.  It reads the
checkpoints of both port CLIs ('state_dict' from ``run_baseline``,
'model_pos' from ``run_fk_gan``, and a full-state snapshot's 'pos_state')
and reference ``ckpt_*.pth.tar`` files under either key; the posenet name
comes from the checkpoint where it holds one, else from ``--posenet_name``.
H36M is scored unflipped and 3DHP flip-averaged; ``--action-wise`` (on by
default) adds the H36M P1 of each action, and ``--Path_3DPW <npz>``
(``pose3d`` (N, 24|16, 3) metres, ``pose2d`` (N, 16, 2) normalized) a
flip-averaged 3DPW score: SMPL-24 joints are mapped to the H36M-16 layout
(``data/pw3d.py``) and P1/P2 taken over the 14 mapped joints after
mean-centring.  Checkpoints of the multi-frame ``mulit_farme_*`` posenets
are refused until video mode is ported.

    python -m dhaug_torch.run_evaluate --evaluate checkpoint/.../ckpt_best.ckpt \\
        --posenet_name videopose

Runs on CUDA unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

import dhaug_torch
from dhaug_torch.data.pw3d import PW3D_TO_16POINTS_TABLE, convert_to_16
from dhaug_torch.models.factory import make_posenet
from dhaug_torch.ops.metrics import mpjpe, p_mpjpe
from dhaug_torch.train.config import parse_baseline_args
from dhaug_torch.train.data_prep import prepare_data
from dhaug_torch.train.posenet import evaluate, evaluate_both, predict
from dhaug_torch.train.runners import refuse_unported
from dhaug_torch.utils.checkpoint import load_posenet_checkpoint, resolve_posenet_weights


def score_3dpw(model, path: str, batch_size: int) -> dict:
    """P1/P2 (mm) of flip-averaged predictions on a 3DPW-style npz."""
    data = np.load(path)
    gt3d, in2d = np.asarray(data["pose3d"], np.float32), np.asarray(data["pose2d"], np.float32)
    if gt3d.shape[1] == 24:
        gt3d = convert_to_16(gt3d, PW3D_TO_16POINTS_TABLE)
        mapped = sorted(PW3D_TO_16POINTS_TABLE.values())
    else:
        mapped = list(range(16))
    pred = predict(model, in2d, batch_size, flip=True)[:, mapped]
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
    refuse_unported(args)

    print("==> Loading dataset...")
    bundle = prepare_data(args)
    model = make_posenet(args.posenet_name, stages=args.stages, dropout=args.dropout,
                         architecture=args.architecture, skeleton=bundle.dataset.skeleton(),
                         flag="test").to(device)
    resolve_posenet_weights(ckpt, model)

    h36m, dhp = evaluate_both(model, bundle, args.batch_size)
    print(f"H36M  : P1 {h36m['p1']:.2f} mm | P2 {h36m['p2']:.2f} mm")
    print(f"3DHP  : P1 {dhp['p1']:.2f} mm | P2 {dhp['p2']:.2f} mm "
          f"| PCK {dhp['pck']:.2f} | AUC {dhp['auc']:.2f}")
    result = {"h36m": h36m, "dhp": dhp, "posenet_name": args.posenet_name}

    if args.Path_3DPW:
        pw3d = score_3dpw(model, args.Path_3DPW, args.batch_size)
        print(f"3DPW  : P1 {pw3d['p1']:.2f} mm | P2 {pw3d['p2']:.2f} mm "
              f"({pw3d['joints']}-joint protocol, {pw3d['frames']} frames)")
        result["pw3d"] = pw3d

    if args.action_wise:
        actions = np.asarray(bundle.actions_valid)
        print("H36M per-action P1 (mm):")
        result["actions"] = {}
        for action in sorted(set(actions.tolist())):
            sel = np.where(actions == action)[0]
            m = evaluate(model, bundle.h36m_test.poses_2d[sel], bundle.h36m_test.poses_3d[sel],
                         args.batch_size)
            print(f"  {action:14s} {m['p1']:7.2f}")
            result["actions"][action] = m["p1"]
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
