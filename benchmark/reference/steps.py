"""Plain PyTorch training and synthesis steps of DH-AUG, for the benchmark's
reference: the generator's head-to-pose map, the WGAN-GP critic update,
the video GAN iteration (critics every iteration, the generator every
fifth), the posenet steps, the bone-length re-skin and the bulk synthesis
body.

They follow the published training loop (model_fk_gan_train.py,
video_GAN_fun.py, model_pos_train / video_mode_operate.py of DH-AUG) and
draw their random numbers from an explicit ``torch.Generator`` in the
order the loop draws them, so that the reference and the program, seeded
alike, see the same noise, bone scalers, cameras, penalty interpolates and
dropout masks.  Single device, no data or tensor parallelism.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import geometry as geo
from benchmark.reference import nets

# the 31 head slots of the 37-d [34 DOF + 3 global rotation] vector, the
# per-slot angle ranges in degrees, and the 8 mirrored bone-scaler groups
NONZERO_SLOTS = (0, 1, 2, 3, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
                 24, 25, 26, 27, 29, 30, 31, 32, 34, 35, 36)
ANGLE_RANGES = (
    (-110, 65), (-110, 65), (-110, 180), (-180, 0), (0, 0),
    (-65, 110), (-65, 110), (-110, 180), (-180, 0), (0, 0),
    (-180, 180), (-180, 180), (-180, 180), (-180, 180), (-180, 180),
    (-180, 180), (-180, 180), (-180, 180), (-180, 180), (-180, 180),
    (-180, 180), (-180, 180), (0, 0), (0, 0),
    (-155, 65), (-155, 65), (-100, 180), (0, 180), (0, 0),
    (-65, 155), (-65, 155), (-100, 180), (0, 180), (0, 0),
    (-180, 180), (-180, 180), (-180, 180),
)
_LO = np.array([lo for lo, _ in ANGLE_RANGES], np.float32)
_HI = np.array([hi for _, hi in ANGLE_RANGES], np.float32)
ANGLE_SCALE = (_HI - _LO) / 2.0
ANGLE_MID = (_HI + _LO) / 2.0
SCALER_GROUP_OF_BONE = (0, 0, 1, 1, 2, 2, 3, -1, 4, 4, 5, 5, 6, 6, 7)
N_CRITIC = 5


def head_to_pose_inputs(head: torch.Tensor):
    """Head (..., 35) -> (33 chain angles, 3 global-rotation angles, root),
    degrees and metres: tanh, the 31-slot scatter and the range rescale."""
    squashed = torch.tanh(head)
    root = squashed[..., 32:35] * 10.0
    angles = head.new_zeros(head.shape[:-1] + (37,))
    angles[..., list(NONZERO_SLOTS)] = squashed[..., :31]
    angles = (angles * torch.as_tensor(ANGLE_SCALE, device=head.device)
              + torch.as_tensor(ANGLE_MID, device=head.device))
    return angles[..., :33], angles[..., 34:37], root


def scale_bones(bone_len: torch.Tensor, scaler8: torch.Tensor) -> torch.Tensor:
    groups = torch.zeros(8, 15, dtype=scaler8.dtype, device=scaler8.device)
    for bone, group in enumerate(SCALER_GROUP_OF_BONE):
        if group >= 0:
            groups[group, bone] = 1.0
    return bone_len * (1.0 + scaler8 @ groups)


def draw_scaler8(n: int, generator) -> torch.Tensor:
    return torch.randint(-200, 200, (n, 8), generator=generator,
                         device=generator.device).float() / 1000.0


def fake_world(gen: torch.nn.Module, bone_len: torch.Tensor, generator, frames: int = 1):
    """noise -> generator -> FK world poses (B, 16, 3), or clips
    (B, F, 16, 3) whose frames share the clip's bone scalers; and the
    scaled bone lengths (B, 15) the FK was given."""
    B = bone_len.shape[0]
    head = gen(torch.randn((B, 128), generator=generator, device=bone_len.device))
    scaled = scale_bones(bone_len, draw_scaler8(B, generator))
    angles, grot, root = head_to_pose_inputs(head.reshape(B * frames, 35))
    bones = scaled.repeat_interleave(frames, dim=0) if frames > 1 else scaled
    pose = geo.fk_world_pose_16(angles, bones, grot, root)
    return (pose if frames == 1 else pose.reshape(B, frames, 16, 3)), scaled.detach()


def critic_update(critic, opt, real, fake, lam: float, generator, granularity: int = 1):
    """One WGAN-GP critic update: minimize D(fake) - D(real) + lam * GP, the
    penalty on uniform interpolates (one alpha per row of ``granularity``
    rows a sample).  Returns the update's (mean real score, mean fake
    score)."""
    B = real.shape[0]
    Bg = B * granularity
    r = real.reshape(Bg, -1)
    f = fake.reshape(Bg, -1)
    alpha = torch.rand((Bg, 1), generator=generator, device=r.device)
    interp = (alpha * r + (1.0 - alpha) * f).requires_grad_(True)
    d_real = critic(r.reshape(real.shape)).mean()
    d_fake = critic(f.reshape(real.shape)).mean()
    d_interp = critic(interp.reshape(real.shape))
    (g,) = torch.autograd.grad(d_interp.sum(), interp, create_graph=True)
    gp = torch.mean((torch.sqrt(torch.sum(g ** 2, dim=1) + 1e-12) - 1.0) ** 2) * lam
    params = list(critic.parameters())
    for p, grad in zip(params, torch.autograd.grad(d_fake - d_real + gp, params)):
        p.grad = grad
    opt.step()
    return torch.stack([d_real, d_fake]).detach()


def generator_update(gen_opt, gen, loss):
    params = list(gen.parameters())
    for p, grad in zip(params, torch.autograd.grad(loss, params)):
        p.grad = grad
    gen_opt.step()


class VideoGan:
    """The video GAN iteration: the single-frame critics on every frame,
    the motion critics on whole clips (mirror and playback duplicates),
    the generator every fifth iteration scored by all four."""

    def __init__(self, gen, d3d, d2d, md3d, md2d, lr_g, lr_d, cameras, frames: int,
                 lam=10.0, w3d=1.0, w2d=0.2, w3d_motion=1.0, w2d_motion=1.0):
        self.gen, self.d3d, self.d2d, self.md3d, self.md2d = gen, d3d, d2d, md3d, md2d
        adam = lambda net, lr: torch.optim.Adam(net.parameters(), lr=lr, betas=(0.5, 0.9))
        self.opts = {"gen": adam(gen, lr_g), **{name: adam(net, lr_d) for name, net in
                     (("d3d", d3d), ("d2d", d2d), ("md3d", md3d), ("md2d", md2d))}}
        self.quats, self.trans, self.intrs = cameras
        self.frames, self.lam = frames, lam
        self.w3d, self.w2d, self.w3d_motion, self.w2d_motion = w3d, w2d, w3d_motion, w2d_motion

    def _update(self, name: str, real, fake, generator, granularity: int = 1):
        return critic_update(getattr(self, name), self.opts[name], real, fake, self.lam,
                             generator, granularity)

    def _motion(self, name, real, fake, generator, g):
        s = self._update(name, real, fake, generator, g)
        return (s + self._update(name, geo.time_reverse(real), geo.time_reverse(fake),
                                 generator, g)) / 2

    def critics(self, real_clip3d, cam16, real_clip2d, generator):
        B, F = real_clip3d.shape[:2]
        with torch.no_grad():
            bone_len = geo.bone_lengths_fk(real_clip3d[:, 0])
            world = geo.camera_to_world_batch(real_clip3d.reshape(B * F, 16, 3),
                                              cam16[:, 9:13].repeat_interleave(F, dim=0),
                                              cam16[:, 13:16].repeat_interleave(F, dim=0))
            real_rel = (world - world[:, :1]).reshape(B, F, 16, 3)
            fake, bones = fake_world(self.gen, bone_len, generator, F)
            fake_root = fake[:, :, :1]
            fake_rel = fake - fake_root
        flat = lambda x, c: x.reshape(-1, 16, c)
        s3 = self._update("d3d", flat(real_rel, 3), flat(fake_rel, 3), generator)
        m3 = self._motion("md3d", real_rel, fake_rel, generator, 1)
        real_f, fake_f = geo.flip_pose(real_rel), geo.flip_pose(fake_rel)
        s3 = (s3 + self._update("d3d", flat(real_f, 3), flat(fake_f, 3), generator)) / 2
        m3 = (m3 + self._motion("md3d", real_f, fake_f, generator, 1)) / 2
        with torch.no_grad():
            cam_idx = torch.randint(0, self.quats.shape[0], (), generator=generator,
                                    device=self.quats.device)
            intr = self.intrs[cam_idx][None].expand(B * F, 9)
            fake_cam3d = geo.world_to_camera_batch((fake_rel + fake_root).reshape(B * F, 16, 3),
                                                   self.quats[cam_idx][None],
                                                   self.trans[cam_idx][None])
            fake_2d = geo.project_to_2d(fake_cam3d, intr).reshape(B, F, 16, 2)
        s2 = self._update("d2d", flat(real_clip2d, 2), flat(fake_2d, 2), generator)
        m2 = self._motion("md2d", real_clip2d, fake_2d, generator, F)
        real2_f, fake2_f = geo.flip_pose(real_clip2d), geo.flip_pose(fake_2d)
        s2 = (s2 + self._update("d2d", flat(real2_f, 2), flat(fake2_f, 2), generator)) / 2
        m2 = (m2 + self._motion("md2d", real2_f, fake2_f, generator, F)) / 2
        return (cam_idx, bone_len, fake_cam3d.reshape(B, F, 16, 3), fake_2d,
                intr.reshape(B, F, 9), bones, s3, s2, m3, m2)

    def generator(self, bone_len, cam_idx, generator):
        B, F = bone_len.shape[0], self.frames
        fake, _ = fake_world(self.gen, bone_len, generator, F)
        cam3d = geo.world_to_camera_batch(fake.reshape(B * F, 16, 3), self.quats[cam_idx][None],
                                          self.trans[cam_idx][None])
        fake_2d = geo.project_to_2d(cam3d, self.intrs[cam_idx][None].expand(B * F, 9))
        fake_2d = fake_2d.reshape(B, F, 16, 2)
        fake_rel = fake - fake[:, :, :1]
        rev = geo.time_reverse
        adv3d = self.d3d(fake_rel.reshape(-1, 16, 3)).mean()
        adv2d = self.d2d(fake_2d.reshape(-1, 16, 2)).mean()
        m3 = (self.md3d(fake_rel).mean() + self.md3d(rev(fake_rel)).mean()) / 2
        m2 = (self.md2d(fake_2d).mean() + self.md2d(rev(fake_2d)).mean()) / 2
        with torch.no_grad():   # the mirrored branches are detached
            f3, f2 = geo.flip_pose(fake_rel), geo.flip_pose(fake_2d)
            adv3d_f = self.d3d(f3.reshape(-1, 16, 3)).mean()
            adv2d_f = self.d2d(f2.reshape(-1, 16, 2)).mean()
            fm3 = (self.md3d(f3).mean() + self.md3d(rev(f3)).mean()) / 2
            fm2 = (self.md2d(f2).mean() + self.md2d(rev(f2)).mean()) / 2
        loss = -(self.w3d * (adv3d + adv3d_f) / 2 + self.w2d * (adv2d + adv2d_f) / 2
                 + self.w3d_motion * (m3 + fm3) / 2 + self.w2d_motion * (m2 + fm2) / 2)
        generator_update(self.opts["gen"], self.gen, loss)
        return loss.detach()


def root_relative(pose):
    return pose - pose[..., :1, :]


def posenet_step(model, opt, x, y_rel, max_norm: float, generator):
    """One posenet update: MPJPE on root-relative targets, the gradients
    clipped to a global norm."""
    model.train()
    out = model(x, generator)
    loss = torch.mean(torch.linalg.vector_norm(out - y_rel, dim=-1))
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    opt.step()
    return loss.detach()


def video_posenet_steps(model, opt, x, y_rel, max_norm: float, generator, playback: bool):
    """The clip step, its time reversal (``playback``), its mirror and the
    reversed mirror; the base step's loss."""
    rev = geo.time_reverse
    loss = posenet_step(model, opt, x, y_rel, max_norm, generator)
    if playback:
        posenet_step(model, opt, rev(x), y_rel, max_norm, generator)
    xf, yf = geo.flip_pose(x), geo.flip_pose(y_rel)
    posenet_step(model, opt, xf, yf, max_norm, generator)
    if playback:
        posenet_step(model, opt, rev(xf), yf, max_norm, generator)
    return loss


@torch.no_grad()
def reskin_rows(cam3d: torch.Tensor, cam9: torch.Tensor, lengths_tree: torch.Tensor):
    new3d = geo.reskin_pose(cam3d, lengths_tree)
    return new3d, geo.project_to_2d(new3d, cam9)


def trunk_bf16(gen: nets.Generator, noise: torch.Tensor, operand=None) -> torch.Tensor:
    """The synthesis trunk in bf16 products with float32 sums, biases and
    residuals: every product operand rounded to bf16 (or by ``operand``)."""
    rnd = operand or (lambda t: t.to(torch.bfloat16).float())
    mm = lambda x, layer: rnd(x) @ rnd(layer.weight).t() + layer.bias
    h = torch.relu(mm(noise, gen.prelude.fc))
    for block in gen.blocks:
        y = torch.relu(mm(h, block.fc1))
        h = torch.relu(mm(y, block.fc2) + h)
    return mm(h, gen.head)


def fp8_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with one scale a tensor (its largest
    magnitude to 448): the correctness control of the bf16 trunk."""
    scale = t.abs().max().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale
