"""Posenet training and evaluation, single-frame and video.

Port of ``dhaug_tpu/train/posenet.py`` with ``train/runners.py``'s
``make_eval_both_scan`` folded in:

* single-frame nets (``mlp``, ``gcn``, ``videopose``: (B, 16, 2) in,
  (B, 16, 3) out): the MSE step, the flip duplicate as a second full
  optimizer step, ``train_epoch_scan``'s permutation draw, and the
  per-frame-weighted evaluation, H36M unflipped and 3DHP flip-averaged;
* video nets (``mulit_farme_*``: (B, F, 16, 2) clips in, the centre frame
  (B, 1, 16, 3) out): the MPJPE step and its playback, flip and
  flip+playback duplicates, each a full optimizer update with its own
  dropout draw, over fake clips or real windows gathered by index; and the
  sequence-weighted whole-sequence evaluation.

Under data parallelism (``parallel/mesh.py``) every pass draws the global
permutation and each rank trains on its rows of every batch; the gradients
are averaged over the ranks before the global-norm clip, so the clip sees
the global gradient, and the returned mean loss is the ranks' mean; under
tensor parallelism the clip adds the column blocks' squares over the model
group (``train/state.clip_by_global_norm``).  The
frame-weighted evaluation shards each batch over the ranks and
all-reduces the sums of the per-frame errors; the sequence-weighted one
runs whole on every rank.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dhaug_torch.ops.augment import flip_pose, time_reverse
from dhaug_torch.ops.metrics import mpjpe, p_mpjpe_per_sample
from dhaug_torch.parallel import mesh
from dhaug_torch.parallel.tensor import sharded_parameters
from dhaug_torch.train.state import clip_by_global_norm
from dhaug_torch.utils.profiling import span, spanned

_AUC_THRESHOLDS = np.linspace(0.0, 150.0, 31)


def root_relative(pose: torch.Tensor) -> torch.Tensor:
    """Subtract the hip joint (joint 0)."""
    return pose - pose[..., :1, :]


@spanned("posenet.step")
def train_step(model, opt, inputs_2d, targets_3d_rel, max_norm: float,
               generator=None, criterion: str = "mse") -> torch.Tensor:
    """One step on root-relative targets with global-norm clipping;
    ``criterion`` 'mse' (single-frame, nn.MSELoss) or 'mpjpe' (video)."""
    with span("posenet.forward"):
        model.train()
        out = model(inputs_2d, generator)
        loss = torch.mean((out - targets_3d_rel) ** 2) if criterion == "mse" else \
            mpjpe(out, targets_3d_rel)
    with span("posenet.backward"):
        opt.zero_grad(set_to_none=True)
        loss.backward()
    with span("posenet.optimizer"):
        params = [p for p in model.parameters() if p.grad is not None]
        for p, g in zip(params, mesh.current().all_reduce_grads([p.grad for p in params])):
            p.grad = g
        clip_by_global_norm(model.parameters(), max_norm, sharded_parameters(model))
        opt.step()
    return loss.detach()


@spanned("posenet.pass")
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
    dp = mesh.current()
    losses = []
    for sel in idx:
        sel = dp.rows(sel)
        x = dev2d[sel]
        y = root_relative(dev3d[sel])
        losses.append(train_step(model, opt, x, y, max_norm, generator))
        if flip:
            train_step(model, opt, flip_pose(x), flip_pose(y), max_norm, generator)
    return float(dp.mean(torch.stack(losses).mean()))


def video_steps(model, opt, x, y_rel, max_norm: float, generator=None, flip: bool = True,
                playback: bool = False) -> torch.Tensor:
    """One batch of the video passes: the MPJPE step on clips ``x``
    (B, F, 16, 2) and centre-frame targets ``y_rel`` (B, 1, 16, 3), then the
    time-reversed clip with the same target (``playback``), the mirrored
    pair (``flip``) and the mirrored reversed clip
    (video_mode_operate.py:551-629).  Returns the base step's loss."""
    loss = train_step(model, opt, x, y_rel, max_norm, generator, "mpjpe")
    if playback:
        train_step(model, opt, time_reverse(x), y_rel, max_norm, generator, "mpjpe")
    if flip:
        xf, yf = flip_pose(x), flip_pose(y_rel)
        train_step(model, opt, xf, yf, max_norm, generator, "mpjpe")
        if playback:
            train_step(model, opt, time_reverse(xf), yf, max_norm, generator, "mpjpe")
    return loss


@spanned("posenet.pass")
def train_video_clips(model, opt, clips_2d, center_3d, np_rng: np.random.Generator,
                      batch_size: int, max_norm: float, generator=None, flip: bool = True,
                      playback: bool = False) -> float:
    """The pass on fake clips: full-clip 2D (N, F, 16, 2) in, the
    centre-frame 3D (N, 1, 16, 3) as target, in shuffled drop-remainder
    batches (one ``np_rng.permutation`` draw, none when no batch fits)."""
    n = clips_2d.shape[0]
    n_batches = n // batch_size
    if n_batches == 0:
        return float("nan")
    idx = np_rng.permutation(n)[: n_batches * batch_size].reshape(n_batches, batch_size)
    dp = mesh.current()
    idx = dp.rows(torch.as_tensor(idx, device=clips_2d.device).T).T   # rows of every batch
    losses = [video_steps(model, opt, clips_2d[sel], root_relative(center_3d[sel]), max_norm,
                          generator, flip, playback) for sel in idx]
    return float(dp.mean(torch.stack(losses).mean()))


@spanned("posenet.pass")
def train_video_windows(model, opt, loader, np_rng: np.random.Generator, batch_size: int,
                        max_norm: float, generator=None, flip: bool = True,
                        playback: bool = False) -> float:
    """The pass on real data: the centre-frame windows of a
    ``data/chunked.ChunkWindows`` (one ``np_rng.permutation`` of its chunks,
    drop-remainder batches), gathered on the device from its padded
    concatenations."""
    n = loader.n_chunks
    n_batches = n // batch_size
    if n_batches == 0:
        return float("nan")
    device = next(model.parameters()).device
    order = np_rng.permutation(n)[: n_batches * batch_size]
    big2d, big3d, _ = loader.device_arrays(device)
    dp = mesh.current()
    start2d = torch.as_tensor(loader.start2d[order].reshape(n_batches, batch_size),
                              device=device)
    idx3d = torch.as_tensor(loader.idx3d[order].reshape(n_batches, batch_size), device=device)
    win = torch.arange(loader.window, device=device)[None]
    losses = [video_steps(model, opt, big2d[s2[:, None] + win],
                          root_relative(big3d[i3][:, None]), max_norm, generator, flip,
                          playback)
              for s2, i3 in zip(dp.rows(start2d.T).T, dp.rows(idx3d.T).T)]
    return float(dp.mean(torch.stack(losses).mean()))


def _per_sample_metrics(outputs_3d, targets_3d):
    """Per-frame P1/P2 (mm) and per-joint error (mm)."""
    out = root_relative(outputs_3d).reshape(-1, 16, 3)
    tgt = root_relative(targets_3d).reshape(-1, 16, 3)
    err_mm = torch.linalg.vector_norm(out - tgt, dim=-1) * 1000.0
    return err_mm.mean(dim=-1), p_mpjpe_per_sample(out, tgt) * 1000.0, err_mm


def _forward(model, x, flip: bool):
    """Eval-mode prediction; ``flip`` averages it with the mirrored
    prediction of the mirrored input."""
    out = model(x)
    if flip:
        out = (out + flip_pose(model(flip_pose(x)))) / 2.0
    return out


@torch.no_grad()
def predict(model, poses_2d, batch_size: int, flip: bool = False) -> torch.Tensor:
    """Eval-mode predictions for all of ``poses_2d``, in batches, on the
    model's device."""
    device = next(model.parameters()).device
    model.eval()
    dev2d = torch.as_tensor(poses_2d, device=device)
    return torch.cat([_forward(model, dev2d[s:s + batch_size], flip)
                      for s in range(0, dev2d.shape[0], batch_size)])


_NAN_SCORES = {k: float("nan") for k in ("p1", "p2", "pck", "auc")}


@torch.no_grad()
def evaluate_batches(model, batches, flip: bool = False) -> Dict[str, float]:
    """Evaluation with exact per-frame weighting over ``batches`` of
    (inputs_2d, targets_3d[, valid]), tensors on the model's device; a
    ``valid`` count keeps a batch's first frames only.  ``flip`` averages
    each prediction with the mirrored prediction of the mirrored input (the
    3DHP protocol).  The scores come from float64 sums of the valid frames'
    P1, P2 and threshold counts.  In a data-parallel group each batch is
    edge-padded to a multiple of the ranks (eval mode treats every row
    alone), each rank scores its rows and the sums are all-reduced; the
    CLIs' batch sizes divide by the ranks (``mesh.check_request``), so this
    is the JAX package's rule of sharding the batch when it divides
    (dhaug_tpu/train/posenet.py:276)."""
    model.eval()
    dp = mesh.current()
    sums, thresholds = None, None
    for batch in batches:
        x, y = batch[0], batch[1]
        rows = x.shape[0]
        pad = -rows % dp.world
        if pad:
            x = torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])
            y = torch.cat([y, y[-1:].expand((pad,) + y.shape[1:])])
        p1, p2, err = _per_sample_metrics(_forward(model, dp.rows(x), flip), dp.rows(y))
        frames_a_row = p1.shape[0] // (x.shape[0] // dp.world)
        valid = batch[2] if len(batch) > 2 else rows * frames_a_row
        first = dp.rank * p1.shape[0]          # this rank's first frame in the batch
        keep = torch.arange(first, first + p1.shape[0], device=p1.device) < valid
        if sums is None:
            sums = torch.zeros(3 + len(_AUC_THRESHOLDS), dtype=torch.float64, device=p1.device)
            thresholds = torch.as_tensor(_AUC_THRESHOLDS, device=p1.device)
        err = err[keep].double()
        sums += torch.cat([torch.stack([p1[keep].double().sum(), p2[keep].double().sum(),
                                        keep.sum().double()]),
                           (err[..., None] < thresholds).sum((0, 1)).double()])
    if sums is None:
        return dict(_NAN_SCORES)
    n, frames = dp.all_reduce_(sums)[2], sums[3:] / (sums[2] * 16) * 100.0
    p1, p2, pck, auc = (float(v) for v in (sums[0] / n, sums[1] / n, frames[-1], frames.mean()))
    return {"p1": p1, "p2": p2, "pck": pck, "auc": auc}


def evaluate(model, poses_2d, poses_3d, batch_size: int,
             flip: bool = False) -> Dict[str, float]:
    """Whole-set evaluation of frame arrays in batches, with exact
    per-frame weighting: P1, P2 (mm), PCK@150 mm and AUC (%)."""
    device = next(model.parameters()).device
    dev2d = torch.as_tensor(poses_2d, device=device)
    dev3d = torch.as_tensor(poses_3d, device=device)
    return evaluate_batches(model, ((dev2d[s:s + batch_size], dev3d[s:s + batch_size])
                                    for s in range(0, dev2d.shape[0], batch_size)), flip)


@torch.no_grad()
def evaluate_sequences(model, batches, flip: bool = False) -> Dict[str, float]:
    """Whole-sequence evaluation with the reference's SEQUENCE weighting
    (video_mode_operate.py:769-862): each batch is one sequence, (inputs_2d
    (1, T' + 2 pad, 16, 2), targets_3d (1, T', 16, 3), valid T), and each
    sequence's means count once, whatever its length."""
    model.eval()
    per_seq = []
    for batch in batches:
        p1, p2, err = _per_sample_metrics(_forward(model, batch[0], flip), batch[1])
        valid = batch[2] if len(batch) > 2 else None
        p1, p2, err = p1[:valid], p2[:valid], err[:valid]
        frac = torch.stack([torch.mean((err < float(t)).float()) * 100.0
                            for t in _AUC_THRESHOLDS])
        # threshold 150 is the last entry
        per_seq.append(torch.stack([p1.mean(), p2.mean(), frac[-1], frac.mean()]))
    if not per_seq:
        return dict(_NAN_SCORES)
    means = torch.stack(per_seq).cpu().numpy().mean(axis=0)
    return dict(zip(("p1", "p2", "pck", "auc"), (float(m) for m in means)))


def evaluate_both(model, bundle, batch_size: int):
    """H36M (no flip) + 3DHP (flip-averaged): the reference's
    evaluate_posenet pairing (function_aug/model_pos_eval.py:93-109)."""
    h36m = evaluate(model, bundle.h36m_test.poses_2d, bundle.h36m_test.poses_3d,
                    batch_size)
    dhp = evaluate(model, bundle.mpi3d.poses_2d, bundle.mpi3d.poses_3d, batch_size,
                   flip=True)
    return h36m, dhp
