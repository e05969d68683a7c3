"""Posenet training and evaluation for the single-frame path.

Port of ``dhaug_tpu/train/posenet.py`` (the MSE step, the flip duplicate as
a second full optimizer step, ``train_epoch_scan``'s permutation draw, and
the per-frame-weighted evaluation) with ``train/runners.py``'s
``make_eval_both_scan`` folded in: H36M is evaluated unflipped and 3DHP
flip-averaged, each over the whole set in batches.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dhaug_torch.ops.augment import flip_pose
from dhaug_torch.ops.metrics import p_mpjpe_per_sample
from dhaug_torch.train.state import clip_by_global_norm

_AUC_THRESHOLDS = np.linspace(0.0, 150.0, 31)


def root_relative(pose: torch.Tensor) -> torch.Tensor:
    """Subtract the hip joint (joint 0)."""
    return pose - pose[..., :1, :]


def train_step(model, opt, inputs_2d, targets_3d_rel, max_norm: float,
               generator=None) -> torch.Tensor:
    """One MSE step on root-relative targets with global-norm clipping."""
    model.train()
    loss = torch.mean((model(inputs_2d, generator) - targets_3d_rel) ** 2)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    clip_by_global_norm(model.parameters(), max_norm)
    opt.step()
    return loss.detach()


def train_epoch(model, opt, poses_2d, poses_3d, np_rng: np.random.Generator,
                batch_size: int, max_norm: float, generator=None,
                flip: bool = True) -> float:
    """One shuffled pass (drop-remainder batches); with ``flip`` each batch
    is followed by a second full step on its left/right mirror.  Returns the
    mean loss of the unflipped steps."""
    device = next(model.parameters()).device
    n = poses_2d.shape[0]
    n_batches = n // batch_size
    if n_batches == 0:
        return float("nan")
    idx = np_rng.permutation(n)[: n_batches * batch_size].reshape(n_batches, batch_size)
    idx = torch.as_tensor(idx, device=device)
    dev2d = torch.as_tensor(poses_2d, device=device)
    dev3d = torch.as_tensor(poses_3d, device=device)
    losses = []
    for sel in idx:
        x = dev2d[sel]
        y = root_relative(dev3d[sel])
        losses.append(train_step(model, opt, x, y, max_norm, generator))
        if flip:
            train_step(model, opt, flip_pose(x), flip_pose(y), max_norm, generator)
    return float(torch.stack(losses).mean())


def _per_sample_metrics(outputs_3d, targets_3d):
    """Per-frame P1/P2 (mm) and per-joint error (mm)."""
    out = root_relative(outputs_3d).reshape(-1, 16, 3)
    tgt = root_relative(targets_3d).reshape(-1, 16, 3)
    err_mm = torch.linalg.vector_norm(out - tgt, dim=-1) * 1000.0
    return err_mm.mean(dim=-1), p_mpjpe_per_sample(out, tgt) * 1000.0, err_mm


@torch.no_grad()
def evaluate(model, poses_2d, poses_3d, batch_size: int,
             flip: bool = False) -> Dict[str, float]:
    """Whole-set evaluation with exact per-frame weighting: P1, P2 (mm),
    PCK@150 mm and AUC (%).  ``flip`` averages each prediction with the
    mirrored prediction of the mirrored input (the 3DHP protocol)."""
    device = next(model.parameters()).device
    model.eval()
    dev2d = torch.as_tensor(poses_2d, device=device)
    dev3d = torch.as_tensor(poses_3d, device=device)
    n = dev2d.shape[0]
    if n == 0:
        return {k: float("nan") for k in ("p1", "p2", "pck", "auc")}
    p1s, p2s, errs = [], [], []
    for s in range(0, n, batch_size):
        x = dev2d[s:s + batch_size]
        out = model(x)
        if flip:
            out = (out + flip_pose(model(flip_pose(x)))) / 2.0
        p1, p2, err = _per_sample_metrics(out, dev3d[s:s + batch_size])
        p1s.append(p1)
        p2s.append(p2)
        errs.append(err)
    p1 = torch.cat(p1s).cpu().numpy()
    p2 = torch.cat(p2s).cpu().numpy()
    err = torch.cat(errs).cpu().numpy()
    return {
        "p1": float(np.mean(p1)),
        "p2": float(np.mean(p2)),
        "pck": float(np.mean(err < 150.0) * 100.0),
        "auc": float(np.mean([np.mean(err < t) * 100.0 for t in _AUC_THRESHOLDS])),
    }


def evaluate_both(model, bundle, batch_size: int):
    """H36M (no flip) + 3DHP (flip-averaged): the reference's
    evaluate_posenet pairing (function_aug/model_pos_eval.py:93-109)."""
    h36m = evaluate(model, bundle.h36m_test.poses_2d, bundle.h36m_test.poses_3d,
                    batch_size)
    dhp = evaluate(model, bundle.mpi3d.poses_2d, bundle.mpi3d.poses_3d, batch_size,
                   flip=True)
    return h36m, dhp
