"""Single-frame FK-GAN epoch orchestration.

Port of ``dhaug_tpu/gan/single_frame.py:33-295``:

* :func:`reskin_dataset` -- every epoch the real training 3D is re-skinned
  with random bone-length templates and re-projected.
* :func:`build_gan` -- generator + 3D and 2D critics, Adam(lr, 0.5/0.9) each.
* :func:`run_gan_epoch` -- a Python loop over the epoch's batches: critics
  every iteration, generator when the global iteration ``it % 5 == 4``; the
  fake (cam-3D, 2D, intrinsics) buffers stay on the device for the posenet;
  with a ``record_dir`` (``--record_all_picture``) it also dumps the
  generator's angle heatmap every 500 iterations (:func:`dump_angle_heatmap`).

Both functions consume the numpy stream exactly as the JAX package does
(the re-skin's per-chunk template draws, the epoch's two permutations), so
a port run and a JAX run seeded alike see the same data every epoch.  Under
data parallelism (``parallel/mesh.py``) every rank re-skins the whole set
and draws the same permutations, then takes its rows of each batch; the
epoch's fakes are gathered in the one-device order and its scalars averaged
over the ranks, so every rank ends the epoch with the one-device buffers.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dhaug_torch.data.loaders import PoseDataset, PoseTarget
from dhaug_torch.gan.wgan import GanHyper, SingleFrameSteps, camera_bank
from dhaug_torch.models.discriminators import Fk2DDiscriminator, Fk3DDiscriminator
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig, head_to_angles
from dhaug_torch.ops.bones import reskin_pose
from dhaug_torch.ops.camera import project_to_2d
from dhaug_torch.parallel import mesh
from dhaug_torch.parallel.tensor import assert_model_sharded, shard_module_tp
from dhaug_torch.train.state import adam_gan
from dhaug_torch.utils.profiling import span, spanned

# The JAX package re-skins in fixed 16384-row chunks and draws 16384 template
# indices for every chunk, the padded tail's included; the port keeps the
# chunking so its draws match, and uses only the real rows' indices.
_RESKIN_CHUNK = 16384

_SCALAR_KEYS = ("3d_d_real", "3d_d_fake", "3d_wasserstein", "3d_d_cost",
                "2d_d_real", "2d_d_fake", "2d_wasserstein", "2d_d_cost")


def reskin_rows(poses_3d: torch.Tensor, cams: torch.Tensor,
                lengths_tree: torch.Tensor):
    """Each camera-space pose (N, 16, 3) re-skinned to its row of bone
    lengths (N, 15) (tree order) and projected through its camera's
    intrinsics (the first 9 columns of ``cams`` (N, >=9))."""
    new3d = reskin_pose(poses_3d, lengths_tree)
    return new3d, project_to_2d(new3d, cams[:, :9])


@torch.no_grad()
def reskin_dataset(ds: PoseDataset, templates: np.ndarray, rng: np.random.Generator,
                   device) -> PoseDataset:
    """Random bone-length template re-skin of every frame + re-projection.
    Returns a PoseDataset whose 3D/2D poses are tensors on ``device``."""
    n = len(ds)
    poses_3d = torch.as_tensor(ds.poses_3d, device=device)
    cams = torch.as_tensor(ds.cams, device=device)
    tmpl = torch.as_tensor(templates, device=device)
    out3d, out2d = [], []
    for s in range(0, n, _RESKIN_CHUNK):
        e = min(s + _RESKIN_CHUNK, n)
        idx = rng.integers(0, templates.shape[0], size=_RESKIN_CHUNK)[: e - s]
        new3d, new2d = reskin_rows(poses_3d[s:e], cams[s:e],
                                   tmpl[torch.as_tensor(idx, device=device)])
        out3d.append(new3d)
        out2d.append(new2d)
    return PoseDataset(torch.cat(out3d), torch.cat(out2d), ds.cams)


def shard_gan_nets(*nets) -> None:
    """Under tensor parallelism, the GAN nets' wide layers split over the
    model axis, which must shard at least one of them
    (dhaug_tpu/gan/single_frame.py:197-207)."""
    for net in nets:
        shard_module_tp(net)
    assert_model_sharded(*nets)


def build_gan(args, train_subjects, device) -> SingleFrameSteps:
    """G + D3d + D2d with their Adam optimizers (model_fk_gan_train.py:97-128),
    the wide layers column-parallel under tensor parallelism."""
    gen_cfg = GeneratorConfig(dense_dim=args.Gen_DenseDim, output_dim=args.GAN_OUTPUT_DIM,
                              use_pre_angle=args.GAN_whether_use_preAngle,
                              use_global_rot=args.whether_use_RT,
                              bf16_trunk=bool(args.bf16_trunk))
    hyper = GanHyper(lambda_gp=float(args.GAN_LAMBDA), w3d=args.GAN_3d_loss_weight,
                     w2d=args.GAN_2d_loss_weight, flip=args.flip_GAN_model_input,
                     bone_len_scaler=args.bone_len_scaler)
    gen = FkGeneratorNet(gen_cfg).to(device)
    d3d = Fk3DDiscriminator(args.Dis_DenseDim_3D).to(device)
    d2d = Fk2DDiscriminator(args.Dis_DenseDim_2D).to(device)
    shard_gan_nets(gen, d3d, d2d)
    quats, trans, intrs = camera_bank(train_subjects, device)
    return SingleFrameSteps(gen, d3d, d2d,
                            adam_gan(gen.parameters(), args.lr_g),
                            adam_gan(d3d.parameters(), args.lr_d),
                            adam_gan(d2d.parameters(), args.lr_d),
                            gen_cfg, hyper, quats, trans, intrs)


@torch.no_grad()
def dump_angle_heatmap(steps: SingleFrameSteps, seed: int, path: str, batch: int = 512):
    """The distribution heatmap of the generator's 37 DOF/rotation angles
    over ``batch`` noise draws (the reference dumps one every 500 generator
    calls, Fk_generator.py:172-175), and the paper figure's knee-pair
    density beside it.  The noise comes from a generator of its own seeded
    with ``seed``, so the dump leaves the training stream as it was.  Every
    rank runs the generator (its tensor-parallel layers gather over the
    model group); global rank 0 draws."""
    from dhaug_torch.utils.viz import plot_angle_pair_density, plot_dof_angle_heatmap
    device = steps.cam_quats.device
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    head = steps.gen(torch.randn((batch, steps.hyper.noise_dim), generator=g, device=device))
    if not mesh.current().is_main:
        return
    angles37, _ = head_to_angles(head.reshape(batch, -1, steps.gen_cfg.output_dim),
                                 steps.gen_cfg)
    flat = angles37.reshape(-1, 37).cpu().numpy()
    plot_dof_angle_heatmap(flat, path)
    root, ext = os.path.splitext(path)
    plot_angle_pair_density(flat, f"{root}_knee_pair{ext or '.jpg'}",
                            title="generated knee-DOF pair density")


@spanned("gan.epoch")
def run_gan_epoch(steps: SingleFrameSteps, gt2d3d: PoseDataset, target_2d: PoseTarget,
                  target_3d: PoseTarget, batch_size: int, np_rng: np.random.Generator,
                  generator: torch.Generator, summary, writer=None,
                  record_dir: Optional[str] = None):
    """One GAN pass over the epoch's batches.  Returns the fake (cam-3D, 2D,
    intrinsics) dataset for the posenet, or None when no batch fits.  With
    ``record_dir`` (on every rank) the angle heatmap is dumped there when
    this epoch crossed a 500-iteration boundary, or at the very start."""
    device = steps.cam_quats.device
    dev_3d = torch.as_tensor(gt2d3d.poses_3d, device=device)
    dev_cam = torch.as_tensor(gt2d3d.cams, device=device)
    dev_t2d = torch.as_tensor(target_2d.poses, device=device)
    n, n_t2d = len(gt2d3d), len(target_2d)
    # the reference zips independently shuffled loaders, truncating to the
    # shortest (model_fk_gan_train.py:273)
    n_batches = min(n, n_t2d, len(target_3d)) // batch_size
    if n_batches == 0:
        return None
    dp = mesh.current()
    B = batch_size
    idx_real = np_rng.permutation(n)[: n_batches * B].reshape(n_batches, B)
    idx_t2d = np_rng.permutation(n_t2d)[: n_batches * B].reshape(n_batches, B)
    idx_real = torch.as_tensor(idx_real, device=device)
    idx_t2d = torch.as_tensor(idx_t2d, device=device)

    iter_base = summary.train_iter_num
    fake3d, fake2d, intrs = [], [], []
    scalars = {k: [] for k in _SCALAR_KEYS + ("g_cost",)}
    nan = torch.full((), float("nan"), device=device)
    for b in range(n_batches):
        with span("gan.iteration"):
            sel_r, sel_t = dp.rows(idx_real[b]), dp.rows(idx_t2d[b])
            cam_idx, bone_len, f3d, f2d, intr, metrics = steps.critics_step(
                dev_3d[sel_r], dev_cam[sel_r], dev_t2d[sel_t], generator)
            g_cost = nan
            if (iter_base + b) % 5 == 4:
                g_cost = steps.generator_step(bone_len, cam_idx, generator)["g_cost"]
            fake3d.append(f3d)
            fake2d.append(f2d)
            intrs.append(intr)
            for k in _SCALAR_KEYS:
                scalars[k].append(metrics[k])
            scalars["g_cost"].append(g_cost)

    summary.train_discrim_iter_num += n_batches
    summary.train_fakepose_iter_num += sum(1 for b in range(n_batches)
                                           if (iter_base + b) % 5 == 4)
    summary.train_iter_num += n_batches

    # one device->host transfer for the epoch's per-iteration scalars,
    # averaged over the ranks
    with span("gan.scalars"):
        keys = list(scalars)
        host = dp.mean(torch.stack([torch.stack(scalars[k]) for k in keys])).cpu().numpy()
        scalars = dict(zip(keys, host))

        if writer is not None:
            # the reference's writer tags (model_fk_gan_train.py:225-228,316,384)
            tag_of = {"3d_d_real": "Fk_d3d_D_real", "3d_d_fake": "Fk_d3d_D_fake",
                      "3d_wasserstein": "Fk_d3d_Wasserstein_D", "3d_d_cost": "Fk_d3d_D_cost",
                      "2d_d_real": "d2d_D_real", "2d_d_fake": "d2d_D_fake",
                      "2d_wasserstein": "d2d_Wasserstein_D", "2d_d_cost": "d2d_D_cost"}
            for b in range(n_batches):
                for k, tag in tag_of.items():
                    writer.add_scalar(f"train_G_iter_PoseFk/{tag}", float(scalars[k][b]),
                                      iter_base + b)
            for b in np.where(~np.isnan(scalars["g_cost"]))[0]:
                writer.add_scalar("train_G_iter_PoseFk/G_cost", float(scalars["g_cost"][b]),
                                  iter_base + int(b))

    crossed_500 = (iter_base // 500) != (summary.train_iter_num // 500)
    if record_dir is not None and (crossed_500 or iter_base == 0):
        dump_angle_heatmap(steps, iter_base, os.path.join(
            record_dir, f"34DOF_3GlobalRot_heatmap_{iter_base + 1}.jpg"))

    epoch_scalars = {"3d_wasserstein": float(np.nanmean(scalars["3d_wasserstein"])),
                     "2d_wasserstein": float(np.nanmean(scalars["2d_wasserstein"]))}
    if np.isfinite(scalars["g_cost"]).any():
        epoch_scalars["g_cost"] = float(np.nanmean(scalars["g_cost"]))
    summary.record_epoch_scalars(epoch_scalars)

    return PoseDataset(*(gather_batches(dp, parts) for parts in (fake3d, fake2d, intrs)))


def gather_batches(dp: mesh.DataParallel, parts) -> torch.Tensor:
    """An epoch's per-batch tensors (this rank's rows of each batch), every
    rank's rows gathered and put back in the one-device order: batch by
    batch, each batch's rows in rank order."""
    local = torch.stack(parts)                                # (n_batches, B/N, ...)
    if dp.group is None:
        return local.reshape((-1,) + local.shape[2:])
    every = dp.all_gather_rows(local[None])                   # (N, n_batches, B/N, ...)
    return every.transpose(0, 1).reshape((-1,) + local.shape[2:])
