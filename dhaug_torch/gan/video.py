"""Video-mode FK-GAN: the generator, the two single-frame critics and the
two motion critics.

Port of ``dhaug_tpu/gan/video.py``:

* the single-frame critics judge every frame of every clip (batch B x F);
  the motion critics judge whole clips (batch B) and only train once
  ``use_motion`` is on (after ``--single_dis_warmup_epoch`` epochs);
* augmentation axes: the left/right flip (extra critic updates) and time
  reversal, "playback" (extra motion-critic updates);
* the generator's every-5th-iteration update scores up to four critics with
  weights w3d/w2d/w3d_motion/w2d_motion; its flip branches are detached and
  its playback branches carry gradient;
* real clips are root-centred per frame before the 3D critics, so the root
  trajectory reaches only the motion-2D critic, whose gradient penalty is
  taken per frame (``gp_granularity = F``);
* bone lengths come from each real clip's first frame, a clip's frames
  share one set of bone scalers, and one random camera projects a whole
  batch of fake clips.

The reference reshapes the 3D fake with 16*2 before the generator step's
playback branch (video_GAN_fun.py:467), which scrambles frames; the JAX
package reshapes with 16*3, and so does the port.

The epoch follows the JAX package's path for a full-window clip loader:
one permutation of the clip windows an epoch from the loader's own numpy
stream, clip windows gathered on the device, the critics every iteration
and the generator when the global iteration ``it % 5 == 4``.  Random draws
come from a ``torch.Generator``; each can be injected instead (``noise``,
``scaler8``, ``cam_idx``, the 12 GP ``alphas``).  Under data parallelism
each rank takes its rows of every batch of clips, B x F / N poses in the FK
kernels, with the draws and the gradient all-reduce of ``gan/wgan.py``; the
epoch's fake clips are gathered and its scalars averaged over the ranks.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dhaug_torch.gan.single_frame import gather_batches, shard_gan_nets
from dhaug_torch.gan.wgan import GanHyper, SingleFrameSteps, _step, camera_bank, critic_step
from dhaug_torch.models.discriminators import (Fk2DDiscriminator, Fk3DDiscriminator,
                                               MotionFk2DDiscriminator,
                                               MotionFk3DDiscriminator)
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
from dhaug_torch.ops.augment import flip_pose, time_reverse
from dhaug_torch.ops.bones import bone_lengths_fk
from dhaug_torch.ops.camera import camera_to_world_batch, project_to_2d, world_to_camera_batch
from dhaug_torch.parallel import mesh
from dhaug_torch.train.state import adam_gan
from dhaug_torch.utils.profiling import span, spanned

# per-iteration scalars under the reference's writer names
# (video_GAN_fun.py writer_name= values)
_TAG_OF = {"3d_wasserstein": "Fk_d3d_Wasserstein_D", "3d_d_real": "Fk_d3d_D_real",
           "3d_d_fake": "Fk_d3d_D_fake", "2d_wasserstein": "d2d_Wasserstein_D",
           "2d_d_real": "d2d_D_real", "2d_d_fake": "d2d_D_fake"}
_MOTION_TAG_OF = {"motion_3d_wasserstein": "motion_Fk_d3d_Wasserstein_D",
                  "motion_2d_wasserstein": "motion_d2d_Wasserstein_D"}


def _mean(a: dict, b: dict) -> dict:
    return {k: (a[k] + b[k]) / 2 for k in a}


class VideoSteps(SingleFrameSteps):
    """The two programs of a video GAN iteration (the counterpart of
    ``make_video_steps``).  Updates the nets in place; ``synth_fake``
    returns (B, F, 16, 3) world clips."""

    def __init__(self, gen, d3d, d2d, md3d, md2d, gen_opt, d3d_opt, d2d_opt, md3d_opt,
                 md2d_opt, gen_cfg: GeneratorConfig, hyper: GanHyper,
                 cam_quats: torch.Tensor, cam_trans: torch.Tensor, cam_intrs: torch.Tensor,
                 playback: bool):
        super().__init__(gen, d3d, d2d, gen_opt, d3d_opt, d2d_opt, gen_cfg, hyper,
                         cam_quats, cam_trans, cam_intrs)
        self.md3d, self.md2d = md3d, md2d
        self.md3d_opt, self.md2d_opt = md3d_opt, md2d_opt
        self.playback = playback

    def _motion(self, critic, opt, real, fake, generator, alphas, a0: int, g: int) -> dict:
        """A motion critic's update, then its playback duplicate: GP draws
        ``alphas[a0]`` and ``alphas[a0 + 1]``."""
        lam = self.hyper.lambda_gp
        m = critic_step(critic, opt, real, fake, lam, generator, alphas(a0), g)
        if self.playback:
            m = _mean(m, critic_step(critic, opt, time_reverse(real), time_reverse(fake), lam,
                                     generator, alphas(a0 + 1), g))
        return m

    def critics_step(self, real_3d_clip, cam16, real_2d_clip, generator, use_motion: bool,
                     noise=None, scaler8=None, cam_idx=None,
                     alphas: Optional[Sequence[torch.Tensor]] = None):
        """One iteration's critic phase.  real_3d_clip (B, F, 16, 3) camera
        space; cam16 (B, 16) = intrinsic(9) | quat(4) | t(3), one record a
        clip; real_2d_clip (B, F, 16, 2).  ``alphas`` are the 12 GP draws in
        the reference's update order (video_GAN_fun.py:208-418): d3d, md3d,
        md3d-playback, d3d-flip, md3d-flip, md3d-flip-playback, d2d, md2d,
        md2d-playback, d2d-flip, md2d-flip, md2d-flip-playback.  Returns
        (cam_idx, bone_len (B, 15), fake_cam3d (B, F, 16, 3), fake_2d
        (B, F, 16, 2), intr (B, F, 9), metrics)."""
        hyper = self.hyper
        lam = hyper.lambda_gp
        B, F = real_3d_clip.shape[:2]
        a = (lambda i: None) if alphas is None else (lambda i: alphas[i])
        with torch.no_grad():
            bone_len = bone_lengths_fk(real_3d_clip[:, 0])
            real_world = camera_to_world_batch(real_3d_clip.reshape(B * F, 16, 3),
                                               cam16[:, 9:13].repeat_interleave(F, dim=0),
                                               cam16[:, 13:16].repeat_interleave(F, dim=0))
            real_rel = (real_world - real_world[:, :1]).reshape(B, F, 16, 3)
            with span("gan.fake"):
                fake_world = self.synth_fake(bone_len, generator, noise, scaler8)
            fake_root = fake_world[:, :, :1]
            fake_rel = fake_world - fake_root

        m3 = critic_step(self.d3d, self.d3d_opt, real_rel.reshape(-1, 16, 3),
                         fake_rel.reshape(-1, 16, 3), lam, generator, a(0))
        if use_motion:
            mm3 = self._motion(self.md3d, self.md3d_opt, real_rel, fake_rel, generator, a, 1, 1)
        if hyper.flip:
            real_f, fake_f = flip_pose(real_rel), flip_pose(fake_rel)
            m3 = _mean(m3, critic_step(self.d3d, self.d3d_opt, real_f.reshape(-1, 16, 3),
                                       fake_f.reshape(-1, 16, 3), lam, generator, a(3)))
            if use_motion:
                mm3 = _mean(mm3, self._motion(self.md3d, self.md3d_opt, real_f, fake_f,
                                              generator, a, 4, 1))

        with torch.no_grad():
            if cam_idx is None:
                cam_idx = torch.randint(0, self.cam_quats.shape[0], (), generator=generator,
                                        device=self.cam_quats.device)
            q = self.cam_quats[cam_idx][None]
            t = self.cam_trans[cam_idx][None]
            intr = self.cam_intrs[cam_idx][None].expand(B * F, 9)
            fake_cam3d = world_to_camera_batch((fake_rel + fake_root).reshape(B * F, 16, 3), q, t)
            fake_2d = project_to_2d(fake_cam3d, intr).reshape(B, F, 16, 2)

        m2 = critic_step(self.d2d, self.d2d_opt, real_2d_clip.reshape(-1, 16, 2),
                         fake_2d.reshape(-1, 16, 2), lam, generator, a(6))
        if use_motion:
            mm2 = self._motion(self.md2d, self.md2d_opt, real_2d_clip, fake_2d, generator, a,
                               7, F)
        if hyper.flip:
            real2_f, fake2_f = flip_pose(real_2d_clip), flip_pose(fake_2d)
            m2 = _mean(m2, critic_step(self.d2d, self.d2d_opt, real2_f.reshape(-1, 16, 2),
                                       fake2_f.reshape(-1, 16, 2), lam, generator, a(9)))
            if use_motion:
                mm2 = _mean(mm2, self._motion(self.md2d, self.md2d_opt, real2_f, fake2_f,
                                              generator, a, 10, F))

        metrics = {**{f"3d_{k}": v for k, v in m3.items()},
                   **{f"2d_{k}": v for k, v in m2.items()}}
        if use_motion:
            metrics.update({f"motion_3d_{k}": v for k, v in mm3.items()})
            metrics.update({f"motion_2d_{k}": v for k, v in mm2.items()})
        return (cam_idx, bone_len, fake_cam3d.reshape(B, F, 16, 3), fake_2d,
                intr.reshape(B, F, 9), metrics)

    @spanned("gan.generator")
    def generator_step(self, bone_len, cam_idx, generator, use_motion: bool,
                       noise=None, scaler8=None):
        """The every-5th-iteration generator update
        (video_GAN_fun.py:422-558).  Returns {"g_cost": 0-d tensor}."""
        hyper = self.hyper
        B, F = bone_len.shape[0], self.gen_cfg.video_frames
        q = self.cam_quats[cam_idx][None]
        t = self.cam_trans[cam_idx][None]
        intr = self.cam_intrs[cam_idx][None].expand(B * F, 9)

        fake_world = self.synth_fake(bone_len, generator, noise, scaler8)      # (B, F, 16, 3)
        fake_cam3d = world_to_camera_batch(fake_world.reshape(B * F, 16, 3), q, t)
        fake_2d = project_to_2d(fake_cam3d, intr).reshape(B, F, 16, 2)
        fake_rel = fake_world - fake_world[:, :, :1]

        adv3d = self.d3d(fake_rel.reshape(-1, 16, 3)).mean()
        adv2d = self.d2d(fake_2d.reshape(-1, 16, 2)).mean()
        if use_motion:
            adv_m3d = self.md3d(fake_rel).mean()
            adv_m2d = self.md2d(fake_2d).mean()
            if self.playback:
                adv_m3d = (adv_m3d + self.md3d(time_reverse(fake_rel)).mean()) / 2
                adv_m2d = (adv_m2d + self.md2d(time_reverse(fake_2d)).mean()) / 2
        if hyper.flip:
            # the flipped branches are detached (video_GAN_fun.py:493-499)
            with torch.no_grad():
                f3, f2 = flip_pose(fake_rel), flip_pose(fake_2d)
                adv3d_f = self.d3d(f3.reshape(-1, 16, 3)).mean()
                adv2d_f = self.d2d(f2.reshape(-1, 16, 2)).mean()
                if use_motion:
                    fm3 = self.md3d(f3).mean()
                    fm2 = self.md2d(f2).mean()
                    if self.playback:
                        fm3 = (fm3 + self.md3d(time_reverse(f3)).mean()) / 2
                        fm2 = (fm2 + self.md2d(time_reverse(f2)).mean()) / 2
            adv3d = (adv3d + adv3d_f) / 2
            adv2d = (adv2d + adv2d_f) / 2
            if use_motion:
                adv_m3d = (adv_m3d + fm3) / 2
                adv_m2d = (adv_m2d + fm2) / 2

        score = hyper.w3d * adv3d + hyper.w2d * adv2d
        if use_motion:
            score = score + hyper.w3d_motion * adv_m3d + hyper.w2d_motion * adv_m2d
        loss = -score
        _step(self.gen_opt, list(self.gen.parameters()), loss)
        return {"g_cost": loss.detach()}


def build_video_gan(args, train_subjects, video_frames: int, device) -> VideoSteps:
    """G (a head of F x 35) + D3d + D2d + the two motion critics, each with
    its Adam (video_mode_my_get_poseFk_model, model_fk_gan_train.py:131-173),
    the wide layers column-parallel under tensor parallelism."""
    gen_cfg = GeneratorConfig(dense_dim=args.Gen_DenseDim, output_dim=args.GAN_OUTPUT_DIM,
                              use_pre_angle=args.GAN_whether_use_preAngle,
                              use_global_rot=args.whether_use_RT, video_frames=video_frames,
                              bf16_trunk=bool(args.bf16_trunk))
    hyper = GanHyper(lambda_gp=float(args.GAN_LAMBDA), w3d=args.GAN_3d_loss_weight,
                     w2d=args.GAN_2d_loss_weight, w3d_motion=args.GAN_3d_motion_loss_weight,
                     w2d_motion=args.GAN_2d_motion_loss_weight, flip=args.flip_GAN_model_input,
                     bone_len_scaler=args.bone_len_scaler)
    gen = FkGeneratorNet(gen_cfg).to(device)
    d3d = Fk3DDiscriminator(args.Dis_DenseDim_3D).to(device)
    d2d = Fk2DDiscriminator(args.Dis_DenseDim_2D).to(device)
    md3d = MotionFk3DDiscriminator(
        video_frames, args.video_Dis_DenseDim_3D,
        use_pos_branch=args.motion_Dis_whether_use_3dPos_branch,
        use_diff_branch=args.motion_Dis_whether_use_3dDiff_branch).to(device)
    md2d = MotionFk2DDiscriminator(video_frames, args.video_Dis_DenseDim_2D).to(device)
    shard_gan_nets(gen, d3d, d2d, md3d, md2d)
    opts = [adam_gan(gen.parameters(), args.lr_g)] + \
        [adam_gan(net.parameters(), args.lr_d) for net in (d3d, d2d, md3d, md2d)]
    return VideoSteps(gen, d3d, d2d, md3d, md2d, *opts, gen_cfg, hyper,
                      *camera_bank(train_subjects, device),
                      playback=bool(args.GAN_video_playback_input))


@spanned("gan.epoch")
def run_video_gan_epoch(steps: VideoSteps, loader, batch_size: int,
                        generator: torch.Generator, summary, use_motion: bool, writer=None):
    """One pass over a full-window clip loader (``data/chunked.ChunkWindows``
    with ``full_3d_window``).  Returns the fake clips (cam-space 3D
    (N, F, 16, 3), 2D (N, F, 16, 2), intrinsics (N, F, 9)) on the device,
    or None when no batch fits."""
    n_batches = loader.n_chunks // batch_size
    if n_batches == 0:
        return None
    device = steps.cam_quats.device
    dp = mesh.current()
    assert loader.batch_size == batch_size and loader.shuffle
    iter_base = summary.train_iter_num
    tag_of = {**_TAG_OF, **(_MOTION_TAG_OF if use_motion else {})}
    scalars = {tag: [] for tag in list(tag_of.values()) + ["G_cost"]}
    nan = torch.full((), float("nan"), device=device)
    fake3d, fake2d, intrs = [], [], []
    for b, (cams, w3d, w2d) in enumerate(loader.device_epoch(device)):
        with span("gan.iteration"):
            cam_idx, bone_len, f3d, f2d, intr, metrics = steps.critics_step(
                dp.rows(w3d), dp.rows(cams), dp.rows(w2d), generator, use_motion)
            g_cost = nan
            if (iter_base + b) % 5 == 4:
                g_cost = steps.generator_step(bone_len, cam_idx, generator,
                                              use_motion)["g_cost"]
            for key, tag in tag_of.items():
                scalars[tag].append(metrics[key])
            scalars["G_cost"].append(g_cost)
            fake3d.append(f3d)
            fake2d.append(f2d)
            intrs.append(intr)

    summary.train_discrim_iter_num += n_batches
    summary.train_fakepose_iter_num += sum(1 for b in range(n_batches)
                                           if (iter_base + b) % 5 == 4)
    summary.train_iter_num += n_batches

    # one device->host transfer for the epoch's per-iteration scalars,
    # averaged over the ranks
    with span("gan.scalars"):
        tags = list(scalars)
        host = dp.mean(torch.stack([torch.stack(scalars[t]) for t in tags])).cpu().numpy()
        scalars = dict(zip(tags, host))
        # G_cost is NaN off the generator iterations; skip all-NaN columns
        summary.record_epoch_scalars({t: float(np.nanmean(v)) for t, v in scalars.items()
                                      if np.isfinite(v).any()})
        if writer is not None:
            for tag, vals in scalars.items():
                steps_of = np.where(~np.isnan(vals))[0] if tag == "G_cost" \
                    else range(n_batches)
                for b in steps_of:
                    writer.add_scalar(f"train_G_iter_PoseFk/{tag}", float(vals[b]),
                                      iter_base + int(b))
    return tuple(gather_batches(dp, parts) for parts in (fake3d, fake2d, intrs))
