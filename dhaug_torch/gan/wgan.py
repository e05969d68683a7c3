"""WGAN-GP steps of the FK-GAN.

Port of ``dhaug_tpu/gan/wgan.py:45-327`` (the video mode's steps, which use
:func:`critic_step` too, are in ``gan/video.py``):

* :func:`critic_step` -- one critic update minimizing D(fake) - D(real) + GP.
  Real, fake and the GP interpolates go through the critic as one stacked
  (3B) forward; the GP's input gradient comes from
  ``torch.autograd.grad(..., create_graph=True)`` with respect to the
  interpolates.
* :class:`SingleFrameSteps` -- a GAN iteration's critic phase
  (``critics_step``: bone harvest, cam->world, fakes made without gradient,
  flip duplicates averaged, one random camera projecting the whole fake
  batch) and the every-5th generator update (``generator_step``, whose
  flipped branches are detached as in the reference);
* :func:`gradient_penalty` (the penalty alone, on the interpolates),
  :func:`tiled_cam16` and :func:`discriminator_accuracy`, which no training
  path calls.

Random draws come from an explicit ``torch.Generator``; every draw can also
be injected (``noise``, ``scaler8``, ``cam_idx``, ``alphas``) so tests feed
both packages the same numbers.  The optimizers are passed in, so tests can
substitute SGD.

Under data parallelism (``parallel/mesh.py``) the steps take this rank's
rows of the batch.  Every draw, and every injected one, has the global
batch shape and the rank keeps its rows, so N ranks draw what one device
draws; each update's gradients are averaged over the data group
(``_step``), as GSPMD's all-reduce does for the JAX package's steps.  Under
tensor parallelism (``parallel/tensor.py``) a column block's gradient is
whole on its rank and a whole parameter's the same on every rank of a
model group, so the model axis needs no all-reduce; the penalty's double
backward runs through the column-parallel layers' differentiable
backwards.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from dhaug_torch.data import h36m
from dhaug_torch.models.generator import GeneratorConfig, sample_scaler8, synthesize_poses
from dhaug_torch.ops.augment import flip_pose
from dhaug_torch.ops.bones import bone_lengths_fk
from dhaug_torch.ops.camera import camera_to_world_batch, project_to_2d, world_to_camera_batch
from dhaug_torch.parallel import mesh
from dhaug_torch.utils.profiling import span, spanned


class GanHyper(NamedTuple):
    lambda_gp: float = 10.0         # --GAN_LAMBDA
    w3d: float = 1.0                # --GAN_3d_loss_weight
    w2d: float = 0.2                # --GAN_2d_loss_weight
    w3d_motion: float = 1.0         # --GAN_3d_motion_loss_weight
    w2d_motion: float = 1.0         # --GAN_2d_motion_loss_weight
    flip: bool = True               # --flip_GAN_model_input
    bone_len_scaler: str = "different"
    noise_dim: int = 128


def camera_bank(train_subjects, device=None):
    """Every (subject, camera) pair's extrinsics and normalized intrinsics:
    (quats (N, 4), trans (N, 3) metres, intrinsics (N, 9))."""
    quats, trans, intrs = [], [], []
    for subject in train_subjects:
        for cam_idx in range(4):
            cam = h36m.normalized_camera(subject, cam_idx)
            quats.append(cam["orientation"])
            trans.append(cam["translation"])
            intrs.append(cam["intrinsic"])
    return tuple(torch.as_tensor(np.stack(x), dtype=torch.float32, device=device)
                 for x in (quats, trans, intrs))


def tiled_cam16(intr, quat, trans, n: int, device=None) -> torch.Tensor:
    """(n, 16) camera records, intrinsic(9) | quat(4) | t(3) of one camera
    tiled n times: the ``cam16`` layout ``critics_step`` takes."""
    rec = torch.cat([torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1)
                     for x in (intr, quat, trans)])
    return rec.expand(n, 16).contiguous()


def discriminator_accuracy(prediction, label) -> float:
    """Fraction of critic outputs within 0.5 of the label (the reference's
    accuracy probe, utils/gan_utils.py:141-155)."""
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return float(np.mean(np.abs(host(prediction) - host(label)) <= 0.5))


def gradient_penalty(critic: torch.nn.Module, real: torch.Tensor, fake: torch.Tensor,
                     lambda_gp: float, generator: Optional[torch.Generator] = None,
                     alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP on uniform interpolates, each sample flattened: the critic
    alone on the interpolates (the three-pass composition that
    :func:`critic_step` stacks into one forward).  ``alpha`` (B, 1)
    overrides the draw from ``generator``.  Differentiable in the critic's
    parameters."""
    B = real.shape[0]
    r = real.reshape(B, -1)
    f = fake.reshape(B, -1)
    if alpha is None:
        alpha = torch.rand((B, 1), generator=generator, device=r.device, dtype=r.dtype)
    interp = (alpha * r + (1.0 - alpha) * f).requires_grad_(True)
    (g,) = torch.autograd.grad(critic(interp.reshape(real.shape)).sum(), interp,
                               create_graph=True)
    norms = torch.sqrt(torch.sum(g ** 2, dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2) * lambda_gp


def _step(opt: torch.optim.Optimizer, params: list, loss: torch.Tensor) -> None:
    """Gradient of ``loss`` for ``params`` only, averaged over the data
    group, then one optimizer step."""
    grads = mesh.current().all_reduce_grads(torch.autograd.grad(loss, params))
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def critic_step(critic: torch.nn.Module, opt: torch.optim.Optimizer,
                real: torch.Tensor, fake: torch.Tensor, lambda_gp: float,
                generator: Optional[torch.Generator] = None,
                alpha: Optional[torch.Tensor] = None, gp_granularity: int = 1) -> dict:
    """One critic update.  ``gp_granularity`` g splits each sample into g
    GP rows: the interpolation alpha is drawn per row and the gradient norm
    taken per row (the motion-2D critic interpolates per frame).  ``alpha``
    (global B x g, 1) overrides the draw.  Returns the logged scalars (this
    rank's means) as 0-d tensors.  Traced as ``gan.critic.<role>`` (the
    critic class's ``role``) with ``.forward``, ``.grad`` (the penalty's
    input gradient) and ``.optimizer`` (``_step``: the parameters'
    gradient, the all-reduce and the optimizer step)."""
    dp = mesh.current()
    name = "gan.critic." + getattr(critic, "role", "net")
    with span(name):
        B = real.shape[0]
        Bg = B * gp_granularity
        r = real.reshape(Bg, -1)
        f = fake.reshape(Bg, -1)
        if alpha is None:
            alpha = torch.rand((Bg * dp.world, 1), generator=generator, device=r.device,
                               dtype=r.dtype)
        alpha = dp.rows(alpha)
        with span(name + ".forward"):
            interp = (alpha * r + (1.0 - alpha) * f).requires_grad_(True)
            stacked = torch.cat([r, f, interp]).reshape((3 * B,) + tuple(real.shape[1:]))
            scores = critic(stacked)
            d_real = scores[:B].mean()
            d_fake = scores[B:2 * B].mean()
        with span(name + ".grad"):
            (g,) = torch.autograd.grad(scores[2 * B:].sum(), interp, create_graph=True)
            norms = torch.sqrt(torch.sum(g ** 2, dim=1) + 1e-12)
            gp = torch.mean((norms - 1.0) ** 2) * lambda_gp
            loss = d_fake - d_real + gp
        with span(name + ".optimizer"):
            _step(opt, list(critic.parameters()), loss)
        return {"d_real": d_real.detach(), "d_fake": d_fake.detach(), "gp": gp.detach(),
                "d_cost": loss.detach(), "wasserstein": (d_real - d_fake).detach()}


class SingleFrameSteps:
    """The two programs of a single-frame GAN iteration (the counterpart of
    ``make_single_frame_steps``).  Updates the nets in place."""

    def __init__(self, gen, d3d, d2d, gen_opt, d3d_opt, d2d_opt,
                 gen_cfg: GeneratorConfig, hyper: GanHyper,
                 cam_quats: torch.Tensor, cam_trans: torch.Tensor,
                 cam_intrs: torch.Tensor):
        self.gen, self.d3d, self.d2d = gen, d3d, d2d
        self.gen_opt, self.d3d_opt, self.d2d_opt = gen_opt, d3d_opt, d2d_opt
        self.gen_cfg = gen_cfg
        self.hyper = hyper
        self.cam_quats, self.cam_trans, self.cam_intrs = cam_quats, cam_trans, cam_intrs

    def synth_fake(self, bone_len, generator, noise=None, scaler8=None):
        """noise -> fake world pose (B, 16, 3) for this rank's rows of bone
        lengths; ``noise``/``scaler8`` (global batch) override the draws."""
        dp = mesh.current()
        B = bone_len.shape[0] * dp.world
        if noise is None:
            noise = torch.randn((B, self.hyper.noise_dim), generator=generator,
                                device=bone_len.device)
        head = self.gen(dp.rows(noise))
        if scaler8 is None:
            scaler8 = sample_scaler8(B, self.hyper.bone_len_scaler, generator,
                                     bone_len.device)
        return synthesize_poses(head, bone_len, dp.rows(scaler8), self.gen_cfg)

    def critics_step(self, real_3d_cam, cam_param16, target_2d, generator,
                     noise=None, scaler8=None, cam_idx=None,
                     alphas: Optional[Sequence[torch.Tensor]] = None):
        """One iteration's critic phase.  real_3d_cam (B, 16, 3) camera
        space; cam_param16 (B, 16) = intrinsic(9) | quat(4) | t(3);
        target_2d (B, 16, 2).  ``alphas`` are the four GP draws in update
        order (d3d, d3d-flip, d2d, d2d-flip).  Returns (cam_idx, bone_len,
        fake_cam3d, fake_2d, intr, metrics)."""
        hyper = self.hyper
        a = (lambda i: None) if alphas is None else (lambda i: alphas[i])
        with torch.no_grad():
            bone_len = bone_lengths_fk(real_3d_cam)
            real_world = camera_to_world_batch(real_3d_cam, cam_param16[:, 9:13],
                                               cam_param16[:, 13:16])
            real_rel = real_world - real_world[:, :1]
            with span("gan.fake"):
                fake_world = self.synth_fake(bone_len, generator, noise, scaler8)
            fake_root = fake_world[:, :1]
            fake_rel = fake_world - fake_root

        m3 = critic_step(self.d3d, self.d3d_opt, real_rel, fake_rel, hyper.lambda_gp,
                         generator, a(0))
        if hyper.flip:
            m3f = critic_step(self.d3d, self.d3d_opt, flip_pose(real_rel),
                              flip_pose(fake_rel), hyper.lambda_gp, generator, a(1))
            m3 = {k: (m3[k] + m3f[k]) / 2 for k in m3}

        with torch.no_grad():
            if cam_idx is None:
                cam_idx = torch.randint(0, self.cam_quats.shape[0], (), generator=generator,
                                        device=self.cam_quats.device)
            q = self.cam_quats[cam_idx][None]
            t = self.cam_trans[cam_idx][None]
            intr = self.cam_intrs[cam_idx][None].expand(real_3d_cam.shape[0], 9)
            fake_cam3d = world_to_camera_batch(fake_rel + fake_root, q, t)
            fake_2d = project_to_2d(fake_cam3d, intr)

        m2 = critic_step(self.d2d, self.d2d_opt, target_2d, fake_2d, hyper.lambda_gp,
                         generator, a(2))
        if hyper.flip:
            m2f = critic_step(self.d2d, self.d2d_opt, flip_pose(target_2d),
                              flip_pose(fake_2d), hyper.lambda_gp, generator, a(3))
            m2 = {k: (m2[k] + m2f[k]) / 2 for k in m2}

        metrics = {**{f"3d_{k}": v for k, v in m3.items()},
                   **{f"2d_{k}": v for k, v in m2.items()}}
        return cam_idx, bone_len, fake_cam3d, fake_2d, intr, metrics

    @spanned("gan.generator")
    def generator_step(self, bone_len, cam_idx, generator, noise=None, scaler8=None):
        """The every-5th-iteration generator update
        (model_fk_gan_train.py:415-484).  Returns {"g_cost": 0-d tensor}."""
        hyper = self.hyper
        q = self.cam_quats[cam_idx][None]
        t = self.cam_trans[cam_idx][None]
        intr = self.cam_intrs[cam_idx][None].expand(bone_len.shape[0], 9)

        fake_world = self.synth_fake(bone_len, generator, noise, scaler8)
        fake_2d = project_to_2d(world_to_camera_batch(fake_world, q, t), intr)
        fake_rel = fake_world - fake_world[:, :1]
        adv3d = self.d3d(fake_rel).mean()
        adv2d = self.d2d(fake_2d).mean()
        if hyper.flip:
            # the reference detaches the flipped branches (:455-461): they
            # add a constant to the loss and halve the gradient
            with torch.no_grad():
                adv3d_f = self.d3d(flip_pose(fake_rel)).mean()
                adv2d_f = self.d2d(flip_pose(fake_2d)).mean()
            adv3d = (adv3d + adv3d_f) / 2
            adv2d = (adv2d + adv2d_f) / 2
        loss = -(hyper.w3d * adv3d + hyper.w2d * adv2d)  # maximize the fakes' scores
        _step(self.gen_opt, list(self.gen.parameters()), loss)
        return {"g_cost": loss.detach()}
