"""Reference-style PyTorch baseline of the three benchmark lines, on a device.

Port of ``scripts/bench_reference_torch.py``: the same classes and
functions, the same three modes, with every tensor, module and
``torch.Generator`` on ``--device`` and a ``torch.cuda.synchronize()``
before each clock read (the JAX package's script builds everything on the
CPU and reads the clock without a synchronize, so on a card it would time
the CPU).

The pattern is the reference's, written from scratch: a dense generator
trunk (Linear+ReLU prelude, three 2-Linear residual blocks, 35-d head),
then the DH forward kinematics as the reference structures it -- per-link
4x4 matrices built by indexed assignment (forward_kinematics_DH_model.py:
80-116) and *sequential* batched matmuls down each chain with cloned
intermediates (:659-677) -- then the camera projection.

* ``synthesis`` -- one batch of fake-pose synthesis (trunk, FK,
  distorted projection): poses/s;
* ``gan_iter`` -- one WGAN-GP training iteration (synthesis, the 3D and 2D
  critic updates with the gradient penalty, the generator every 5th):
  iterations/s;
* ``video_gan_iter`` -- one video-mode iteration (per-frame synthesis of
  B x F frames, the 12-critic-update block with flip and playback, the
  generator every 5th over all four critics): iterations/s.

Arithmetic is the port's: fp32 with TF32 off for matmuls and convolutions
(``dhaug_torch.set_fp32_precision``, applied when the package is
imported), so the baseline does the fp32 work the port does.
:func:`measure` runs a mode and returns its rate with the device's name;
``dhaug_torch.bench`` calls it in its own process for ``vs_baseline``.

    python -m dhaug_torch.bench_reference_torch --mode synthesis [--batch 65536]
    python -m dhaug_torch.bench_reference_torch --mode gan_iter --device cpu

Runs on CUDA unless ``--device cpu`` is given; ``--device cuda`` without a
card raises.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn as nn

import dhaug_torch
from dhaug_torch.utils.profiling import device_name

DEG = np.pi / 180.0


class ResBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim)
        self.fc2 = nn.Linear(dim, dim)
        self.relu = nn.ReLU(True)

    def forward(self, x):
        y = self.relu(self.fc1(x))
        y = self.fc2(y)
        return self.relu(y + x)


class Trunk(nn.Module):
    def __init__(self, dense=1000, out=35):
        super().__init__()
        self.pre = nn.Sequential(nn.Linear(128, dense), nn.ReLU(True))
        self.b1, self.b2, self.b3 = ResBlock(dense), ResBlock(dense), ResBlock(dense)
        self.head = nn.Linear(dense, out)

    def forward(self, z):
        x = self.pre(z)
        x = self.b3(self.b2(self.b1(x)))
        return self.head(x)


def dh_matrix_batch(alpha_deg, a, d, theta_deg):
    """(B,) tensors -> (B, 4, 4) via indexed assignment, reference-style,
    on ``theta_deg``'s device."""
    B = theta_deg.shape[0]
    al = alpha_deg * DEG
    th = theta_deg * DEG
    m = torch.zeros((B, 4, 4), device=theta_deg.device)
    m[:, 0, 0] = torch.cos(th)
    m[:, 0, 1] = -torch.sin(th)
    m[:, 0, 3] = a
    m[:, 1, 0] = torch.sin(th) * torch.cos(al)
    m[:, 1, 1] = torch.cos(th) * torch.cos(al)
    m[:, 1, 2] = -torch.sin(al)
    m[:, 1, 3] = -torch.sin(al) * d
    m[:, 2, 0] = torch.sin(th) * torch.sin(al)
    m[:, 2, 1] = torch.cos(th) * torch.sin(al)
    m[:, 2, 2] = torch.cos(al)
    m[:, 2, 3] = torch.cos(al) * d
    m[:, 3, 3] = 1.0
    return m


CHAINS = {
    "right_leg": dict(alpha=[0, -90, -90, 0, 0], theta=[0, -90, 180, 0, 0]),
    "left_leg": dict(alpha=[0, 90, 90, 0, 0], theta=[180, -90, 0, 0, 0]),
    "body": dict(alpha=[0] + [-90] * 11 + [90],
                 theta=[90] + [-90] * 10 + [0, 0]),
    "right_hand": dict(alpha=[-90, -90, -90, 0, 0], theta=[-180, -90, 180, 0, 0]),
    "left_hand": dict(alpha=[-90, 90, 90, 0, 0], theta=[0, -90, 0, 0, 0]),
}

# the 16 joints of the 32-joint H36M layout the pipeline keeps
H36M_16 = [0, 1, 2, 3, 6, 7, 8, 12, 13, 15, 17, 18, 19, 25, 26, 27]


def fk_reference_style(angles33, bone_len, B):
    """Sequential per-chain cumulative bmm, as the reference does: (B, 33)
    degrees and (B, 15) lengths -> (B, 32, 3) on their device."""
    device = angles33.device
    zeros = torch.zeros(B, device=device)

    def chain_mats(name, n, ang, a_cols, d_cols):
        spec = CHAINS[name]
        mats = []
        for i in range(n):
            mats.append(dh_matrix_batch(
                torch.full((B,), float(spec["alpha"][i]), device=device),
                a_cols[i], d_cols[i],
                torch.full((B,), float(spec["theta"][i]), device=device) + ang[:, i]))
        return mats

    bl = bone_len
    rl_a = [bl[:, 5], zeros, zeros, bl[:, 3], bl[:, 1]]
    ll_a = [-bl[:, 4], zeros, zeros, bl[:, 2], bl[:, 0]]
    body_a = [zeros] * 12 + [bl[:, 14]]
    body_d = [zeros, zeros, zeros, bl[:, 6], zeros, zeros, bl[:, 7]] + [zeros] * 6
    rh_a = [-bl[:, 9], zeros, zeros, bl[:, 11], bl[:, 13]]
    lh_a = [bl[:, 8], zeros, zeros, bl[:, 10], bl[:, 12]]
    z5 = [zeros] * 5

    chains = {
        "right_leg": chain_mats("right_leg", 5, angles33[:, 0:5], rl_a, z5),
        "left_leg": chain_mats("left_leg", 5, angles33[:, 5:10], ll_a, z5),
        "body": chain_mats("body", 13, angles33[:, 10:23], body_a, body_d),
        "right_hand": chain_mats("right_hand", 5, angles33[:, 23:28], rh_a, z5),
        "left_hand": chain_mats("left_hand", 5, angles33[:, 28:33], lh_a, z5),
    }
    # arm chains prefixed with the first 9 body links
    chains["right_hand"] = [m.clone() for m in chains["body"][:9]] + chains["right_hand"]
    chains["left_hand"] = [m.clone() for m in chains["body"][:9]] + chains["left_hand"]

    points = {}
    for name, mats in chains.items():
        cum = mats[0]
        cums = [cum]
        for m in mats[1:]:
            cum = torch.bmm(cum.clone(), m.clone())
            cums.append(cum)
        points[name] = torch.stack([c[:, :3, 3] for c in cums], dim=1)

    pose = torch.zeros((B, 32, 3), device=device)
    pose[:, 0] = points["body"][:, 0]
    pose[:, 1] = points["right_leg"][:, 0]
    pose[:, 2] = points["right_leg"][:, 3]
    pose[:, 3] = points["right_leg"][:, 4]
    pose[:, 6] = points["left_leg"][:, 0]
    pose[:, 7] = points["left_leg"][:, 3]
    pose[:, 8] = points["left_leg"][:, 4]
    pose[:, 12] = points["body"][:, 3]
    pose[:, 13] = points["body"][:, 6]
    pose[:, 14] = points["body"][:, 12]
    pose[:, 15] = points["body"][:, 12]
    pose[:, 17] = points["left_hand"][:, 9]
    pose[:, 18] = points["left_hand"][:, 12]
    pose[:, 19] = points["left_hand"][:, 13]
    pose[:, 25] = points["right_hand"][:, 9]
    pose[:, 26] = points["right_hand"][:, 12]
    pose[:, 27] = points["right_hand"][:, 13]
    return pose


def synthesis_batch(trunk, bone_len, z):
    """One batch of the ``synthesis`` mode: noise z (B, 128) -> trunk ->
    tanh x 180 angles -> FK -> 16 joints (B, 16, 3), and their pinhole +
    distortion projection (B, 16, 2)."""
    device = z.device
    B = z.shape[0]
    head = trunk(z)
    ang = torch.tanh(head[:, :33]) * 180.0
    pose16 = fk_reference_style(ang, bone_len, B)[:, H36M_16]
    f = torch.tensor([2.29, 2.287], device=device)
    c = torch.tensor([0.025, 0.028], device=device)
    k = torch.tensor([-0.207, 0.247, -0.003], device=device)
    p = torch.tensor([-0.001, -0.001], device=device)
    X = pose16 + torch.tensor([0.0, 0.0, 4.0], device=device)
    XX = torch.clamp(X[..., :2] / X[..., 2:], -1, 1)
    r2 = (XX ** 2).sum(-1, keepdim=True)
    radial = 1 + (k * torch.cat([r2, r2 ** 2, r2 ** 3], -1)).sum(-1, keepdim=True)
    tan = (p * XX).sum(-1, keepdim=True)
    pose2d = f * (XX * (radial + tan) + p * r2) + c
    return pose16, pose2d


class CriticTower(nn.Module):
    """Reference-shaped WGAN critic (Fk_discriminator.py:149-266 pattern):
    prelude + 3 residual blocks + scalar head."""

    def __init__(self, in_dim, dense=1000):
        super().__init__()
        self.pre = nn.Sequential(nn.Linear(in_dim, dense), nn.ReLU(True))
        self.b1, self.b2, self.b3 = (ResBlock(dense), ResBlock(dense),
                                     ResBlock(dense))
        self.head = nn.Linear(dense, 1)

    def forward(self, x):
        return self.head(self.b3(self.b2(self.b1(self.pre(x)))))


class MotionCritic(nn.Module):
    """Reference-style video motion critic: N branch towers (prelude + 3
    residual blocks each, Fk_discriminator.py:381-512 topology at production
    width) + a merge tower."""

    def __init__(self, branch_dims, dense=1000):
        super().__init__()
        self.towers = nn.ModuleList()
        for in_dim in branch_dims:
            self.towers.append(nn.ModuleList([
                nn.Sequential(nn.Linear(in_dim, dense), nn.ReLU(True)),
                ResBlock(dense), ResBlock(dense), ResBlock(dense)]))
        self.merge = nn.Sequential(nn.Linear(dense * len(branch_dims), 100),
                                   nn.ReLU(True))
        self.merge_block = ResBlock(100)
        self.head = nn.Linear(100, 1)

    def forward(self, xs):
        outs = []
        for x, (pre, b1, b2, b3) in zip(xs, self.towers):
            outs.append(b3(b2(b1(pre(x)))))
        return self.head(self.merge_block(self.merge(torch.cat(outs, -1))))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device: torch.device, step, iters: int) -> float:
    """Seconds for ``step(it)`` over it = 0 .. iters - 1, after one warm-up
    ``step(0)``, with the device synchronized before each clock read."""
    step(0)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    for it in range(iters):
        step(it)
    _sync(device)
    return time.perf_counter() - t0


def _generator(device: torch.device, seed: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def bench_synthesis(batch: int, iters: int, dense: int, device: torch.device) -> float:
    """Poses/s of :func:`synthesis_batch` at ``batch`` poses a batch."""
    torch.manual_seed(0)
    g = _generator(device)
    trunk = Trunk(dense).to(device)
    bone_len = torch.rand(batch, 15, generator=g, device=device) * 0.4 + 0.2
    with torch.no_grad():
        dt = _timed(device, lambda it: synthesis_batch(
            trunk, bone_len, torch.randn(batch, 128, generator=g, device=device)), iters)
    return batch * iters / dt


def _gp(critic, real, fake, rows, g):
    """The gradient penalty on uniform interpolates of ``rows`` rows."""
    alpha = torch.rand(rows, 1, generator=g, device=real.device)
    interp = (alpha * real.reshape(rows, -1)
              + (1 - alpha) * fake.reshape(rows, -1)).requires_grad_(True)
    out = critic(interp)
    grads = torch.autograd.grad(out.sum(), interp, create_graph=True)[0]
    return ((grads.norm(2, dim=1) - 1.0) ** 2).mean() * 10.0


def _adam(module):
    return torch.optim.Adam(module.parameters(), lr=1e-4, betas=(0.5, 0.9))


def bench_gan_iteration(batch: int, iters: int, dense: int, device: torch.device) -> float:
    """Iterations/s of one reference-style WGAN-GP training iteration:
    synthesis (trunk + sequential-bmm FK), 3D critic update with gradient
    penalty, 2D critic update with gradient penalty, generator update every
    5th iteration -- the per-iteration work of GAN_solutions_FK_generator
    (model_fk_gan_train.py:273-510, :177-230 per critic, :415-484
    generator)."""
    torch.manual_seed(0)
    g = _generator(device)
    B = batch
    trunk = Trunk(dense).to(device)
    d3d = CriticTower(48, dense).to(device)
    d2d = CriticTower(32, dense).to(device)
    opt_g, opt_3, opt_2 = _adam(trunk), _adam(d3d), _adam(d2d)
    bone_len = torch.rand(B, 15, generator=g, device=device) * 0.4 + 0.2
    real3d = torch.randn(B, 48, generator=g, device=device) * 0.3
    real2d = torch.randn(B, 32, generator=g, device=device) * 0.3

    def synth():
        z = torch.randn(B, 128, generator=g, device=device)
        head = trunk(z)
        ang = torch.tanh(head[:, :33]) * 180.0
        pose16 = fk_reference_style(ang, bone_len, B)[:, H36M_16]
        return pose16.reshape(B, 48), pose16[..., :2].reshape(B, 32)

    def critic_update(critic, opt, real, fake):
        opt.zero_grad()
        loss = critic(fake.detach()).mean() - critic(real).mean() + \
            _gp(critic, real, fake.detach(), B, g)
        loss.backward()
        opt.step()

    def iteration(it):
        fake3d, fake2d = synth()
        critic_update(d3d, opt_3, real3d, fake3d)
        critic_update(d2d, opt_2, real2d, fake2d)
        if it % 5 == 4:
            opt_g.zero_grad()
            f3, f2 = synth()
            g_loss = -(d3d(f3).mean() + 0.2 * d2d(f2).mean())
            g_loss.backward()
            opt_g.step()

    return iters / _timed(device, iteration, iters)


def bench_video_gan_iteration(batch: int, iters: int, dense: int,
                              device: torch.device, frames: int = 9) -> float:
    """Iterations/s of one reference-style VIDEO-mode WGAN-GP training
    iteration: per-frame synthesis (trunk -> F*35 head -> sequential-bmm FK
    over B*F frames), then the 12-critic-update block of
    video_GAN_fun.py:169-418 (single-frame 3D/2D critics + motion critics
    with flip AND playback duplication), generator update every 5th with
    all four critics.  The reference's video batch is 512, receptive field
    9 (README.md:102)."""
    torch.manual_seed(0)
    g = _generator(device)
    B, F = batch, frames
    trunk = Trunk(dense, out=F * 35).to(device)
    d3d = CriticTower(48, dense).to(device)
    d2d = CriticTower(32, dense).to(device)
    # motion-3D: KCS(F*15) + diff-KCS((F-1)*15) + pos(F*48) + diff((F-1)*48)
    md3d = MotionCritic([F * 15, (F - 1) * 15, F * 48, (F - 1) * 48], dense).to(device)
    # motion-2D: pose(F*32) + root-trajectory-diff((F-1)*2)
    md2d = MotionCritic([F * 32, (F - 1) * 2], dense).to(device)
    opts = {m: _adam(m) for m in (trunk, d3d, d2d, md3d, md2d)}
    bone_len = torch.rand(B * F, 15, generator=g, device=device) * 0.4 + 0.2
    real3d = torch.randn(B * F, 48, generator=g, device=device) * 0.3
    real2d = torch.randn(B * F, 32, generator=g, device=device) * 0.3

    def synth():
        z = torch.randn(B, 128, generator=g, device=device)
        head = trunk(z).reshape(B * F, 35)
        ang = torch.tanh(head[:, :33]) * 180.0
        pose16 = fk_reference_style(ang, bone_len, B * F)[:, H36M_16]
        return pose16.reshape(B * F, 48), pose16[..., :2].reshape(B * F, 32)

    def motion_views(flat, per_frame, n_joint_ch):
        """frames (B*F, D) -> the critic's branch inputs: whole-clip rows +
        temporal diffs (+ KCS-width rows for the 3D critic)."""
        clip = flat.reshape(B, F, per_frame)
        diff = clip[:, 1:] - clip[:, :-1]
        if n_joint_ch == 3:   # 3D: kcs(15) proxy rows + pos + diffs
            kcs = clip[..., :15]
            dkcs = diff[..., :15]
            return [kcs.reshape(B, -1), dkcs.reshape(B, -1),
                    clip.reshape(B, -1), diff.reshape(B, -1)]
        root = clip[..., :2]
        droot = root[:, 1:] - root[:, :-1]
        return [clip.reshape(B, -1), droot.reshape(B, -1)]

    def critic_update(critic, real, fake, rows):
        opts[critic].zero_grad()
        loss = critic(fake.detach()).mean() - critic(real).mean() + \
            _gp(critic, real, fake.detach(), rows, g)
        loss.backward()
        opts[critic].step()

    def motion_update(critic, real_flat, fake_flat, ch):
        per = 48 if ch == 3 else 32
        opts[critic].zero_grad()
        loss = critic(motion_views(fake_flat.detach(), per, ch)).mean() - \
            critic(motion_views(real_flat, per, ch)).mean()
        # per-clip GP on the concatenated branch inputs (dis_mode='motion')
        alpha = torch.rand(B, 1, generator=g, device=device)
        r = torch.cat(motion_views(real_flat, per, ch), -1)
        f = torch.cat(motion_views(fake_flat.detach(), per, ch), -1)
        interp = (alpha * r + (1 - alpha) * f).requires_grad_(True)
        widths = [tw[0][0].in_features for tw in critic.towers]
        xs, off = [], 0
        for w in widths:
            xs.append(interp[:, off:off + w])
            off += w
        out = critic(xs)
        grads = torch.autograd.grad(out.sum(), interp, create_graph=True)[0]
        loss = loss + ((grads.norm(2, dim=1) - 1.0) ** 2).mean() * 10.0
        loss.backward()
        opts[critic].step()

    def flipped(x):
        y = x.detach().clone()
        y[:, 0] = -y[:, 0]
        return y

    def played_back(flat, per):
        return torch.flip(flat.reshape(B, F, per), dims=[1]).reshape(B * F, per)

    def iteration(it):
        fake3d, fake2d = synth()
        # the 12-update critic block (flip x playback x motion)
        critic_update(d3d, real3d, fake3d, B * F)
        motion_update(md3d, real3d, fake3d, 3)
        motion_update(md3d, played_back(real3d, 48), played_back(fake3d, 48), 3)
        critic_update(d3d, flipped(real3d), flipped(fake3d), B * F)
        motion_update(md3d, flipped(real3d), flipped(fake3d), 3)
        motion_update(md3d, played_back(flipped(real3d), 48),
                      played_back(flipped(fake3d), 48), 3)
        critic_update(d2d, real2d, fake2d, B * F)
        motion_update(md2d, real2d, fake2d, 2)
        motion_update(md2d, played_back(real2d, 32), played_back(fake2d, 32), 2)
        critic_update(d2d, flipped(real2d), flipped(fake2d), B * F)
        motion_update(md2d, flipped(real2d), flipped(fake2d), 2)
        motion_update(md2d, played_back(flipped(real2d), 32),
                      played_back(flipped(fake2d), 32), 2)
        if it % 5 == 4:
            opts[trunk].zero_grad()
            f3, f2 = synth()
            g_loss = -(d3d(f3).mean() + 0.2 * d2d(f2).mean()
                       + md3d(motion_views(f3, 48, 3)).mean()
                       + md2d(motion_views(f2, 32, 2)).mean())
            g_loss.backward()
            opts[trunk].step()

    return iters / _timed(device, iteration, iters)


MODES = {"synthesis": (bench_synthesis, "poses/s"),
         "gan_iter": (bench_gan_iteration, "iters/s"),
         "video_gan_iter": (bench_video_gan_iteration, "iters/s")}


def measure(mode: str, batch: int, iters: int, dense: int, device: torch.device) -> dict:
    """One mode's rate: {"mode", "value", "unit", "batch", "iters",
    "device"} (``device`` the card's name, or "cpu")."""
    fn, unit = MODES[mode]
    rate = fn(batch, iters, dense, device)
    return {"mode": mode, "value": rate, "unit": unit, "batch": batch, "iters": iters,
            "device": device_name(device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=0,
                    help="default 1024, or 512 clips with --mode video_gan_iter")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dense", type=int, default=1000)
    ap.add_argument("--mode", default="synthesis", choices=list(MODES))
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    device = dhaug_torch.resolve_device(args.device)
    batch = args.batch or (512 if args.mode == "video_gan_iter" else 1024)
    out = measure(args.mode, batch, args.iters, args.dense, device)
    print(f"reference-style torch {args.mode} ({out['device']}): {out['value']:.4f} "
          f"{out['unit']} (batch {batch}, {args.iters} timed after 1 warm-up)", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
