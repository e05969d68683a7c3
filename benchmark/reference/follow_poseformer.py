"""The reference run of the video cell whose posenet is PoseFormer.

:func:`follow_video` is ``follow.follow_video`` with the reference
PoseFormer (``benchmark/reference/poseformer.py``) in VideoPose's place
and F from the architecture's widths (``3,3,3,3``: 81 frames): the first
``steps`` steps, each a chunk of the window's size through the chunk's path
(re-skin, the GAN iterations, both posenet passes, each batch's four
posenet steps), from the fifth iteration of a run on, and the same record
for the check.  Every draw is made where the program makes it; the
posenet's are its stochastic depth masks.

While it runs, the generator's projection follows the program's rule for a
point at camera depth exactly 0 (:func:`project_to_2d_finite`): at 81
frames the generator's update meets one about once in a hundred, and
``geometry.project_to_2d``'s plain divide turns its gradient into NaN.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference import geometry, nets, poseformer, steps
from benchmark.reference.cameras import camera_bank
from benchmark.reference.follow import (FIRST_ITERATION, Inputs, _build, _gan_hyper, changes,
                                        first_moments, leaves, sequence_windows)


def posenet(p: dict) -> poseformer.PoseFormer:
    """The configuration's PoseFormer, its frames the widths' product."""
    return poseformer.PoseFormer(int(np.prod(p["filter_widths"])), 16, p["embed_dim_ratio"],
                                 p["depth"], p["num_heads"], p["mlp_ratio"],
                                 p["drop_path_rate"])


_PROJECT_TO_2D = geometry.project_to_2d


def project_to_2d_finite(X: torch.Tensor, camera_params: torch.Tensor) -> torch.Tensor:
    """``geometry.project_to_2d``, but where its gradient is taken a point
    at depth exactly 0 enters as a constant: the same values everywhere,
    the same gradient at every other point, and at that one 0 (the clamp's
    gradient there) instead of 0 x inf = NaN."""
    if torch.is_grad_enabled() and X.requires_grad:
        X = torch.where(X[..., 2:] == 0, X.detach(), X)
    return _PROJECT_TO_2D(X, camera_params)


@contextlib.contextmanager
def finite_projection():
    """``geometry.project_to_2d`` is :func:`project_to_2d_finite` inside."""
    geometry.project_to_2d = project_to_2d_finite
    try:
        yield
    finally:
        geometry.project_to_2d = _PROJECT_TO_2D


def follow_video(config: dict, traffic: dict, seed_list: list, device, steps_n: int = 3,
                 precision: str = "fp32") -> dict:
    """The first ``steps_n`` steps of the cell, each
    ``traffic["chunk_batches"]`` iterations; ``precision`` ``"tf32"`` rounds
    every product of every net to TF32, the attention's included."""
    with finite_projection():
        return _follow_video(config, traffic, seed_list, device, steps_n, precision)


def _follow_video(config: dict, traffic: dict, seed_list: list, device, steps_n: int,
                  precision: str) -> dict:
    g, p = config["gan"], config["posenet"]
    F = int(np.prod(p["filter_widths"]))
    pad = (F - 1) // 2
    inp = Inputs(config, seed_list, device)
    named = {"gen": nets.Generator(g["gen_dense"], head=F * 35),
             "d3d": nets.Critic3D(g["dis_dense_3d"]), "d2d": nets.Critic2D(g["dis_dense_2d"]),
             "md3d": nets.MotionCritic3D(F, g["video_dis_dense_3d"]),
             "md2d": nets.MotionCritic2D(F, g["video_dis_dense_2d"]),
             "posenet": posenet(p)}
    _build(named, inp, device, precision)
    if precision == "tf32":
        poseformer.use_tf32(named["posenet"])
    gan = steps.VideoGan(named["gen"], named["d3d"], named["d2d"], named["md3d"], named["md2d"],
                         g["lr_g"], g["lr_d"], camera_bank(device), F, **_gan_hyper(config),
                         w3d_motion=g["w3d_motion"], w2d_motion=g["w2d_motion"])
    pos_opt = torch.optim.Adam(named["posenet"].parameters(), lr=p["lr"], betas=(0.9, 0.999))
    opts = {**gan.opts, "posenet": pos_opt}
    B, K = traffic["batch"], traffic["chunk_batches"]
    pool, rng, gen_rng, tmpl = inp.pool, inp.np_rng, inp.generator, inp.templates
    L = pool.sequence_frames
    per_step = K * B // L
    start = {leaf: t.detach().clone() for leaf, t in leaves(named)}
    record = {"losses": [], "bones": [], "intrs": [], "fakes": []}
    iteration = FIRST_ITERATION
    win = torch.arange(F, device=device)[None]
    model = named["posenet"]

    def posenet_pass(clips, targets):
        return [steps.video_posenet_steps(model, pos_opt, x, steps.root_relative(y),
                                          p["max_norm"], gen_rng, p["playback"])
                for x, y in zip(clips, targets)]

    for c in range(steps_n):
        rows = slice(c * per_step * L, (c + 1) * per_step * L)
        p3, p2, cams = pool.cam3d[rows], pool.pose2d[rows], pool.cam16[rows]
        # re-skin: one template a sequence, then the clip loader's seed
        t_idx = np.repeat([int(rng.integers(0, tmpl.shape[0])) for _ in range(per_step)], L)
        new3d, new2d = steps.reskin_rows(p3, cams[:, :9],
                                         tmpl[torch.as_tensor(t_idx, device=device)])
        loader_rng = np.random.default_rng(int(rng.integers(0, 2 ** 31)))
        big3d, starts = sequence_windows(new3d.reshape(per_step, L, 16, 3), pad)
        big2d, _ = sequence_windows(new2d.reshape(per_step, L, 16, 2), pad)
        order = torch.as_tensor(loader_rng.permutation(K * B).reshape(K, B), device=device)
        scores, f3d, f2d = [], [], []
        for b in range(K):
            st = starts[order[b]][:, None] + win
            cam_idx, bone_len, fc3, fc2, intr, bones, s3, s2, m3, m2 = gan.critics(
                big3d[st], cams[order[b]], big2d[st], gen_rng)
            gc = (gan.generator(bone_len, cam_idx, gen_rng)
                  if (iteration + b) % steps.N_CRITIC == steps.N_CRITIC - 1
                  else torch.tensor(float("nan"), device=device))
            scores.append(torch.cat([s3, s2, gc[None], (m3[:1] - m3[1:]), (m2[:1] - m2[1:])]))
            f3d.append(fc3)
            f2d.append(fc2)
            record["bones"].append(bones)
            record["intrs"].append(intr)
        iteration += K
        f3d, f2d = torch.cat(f3d), torch.cat(f2d)
        record["fakes"].append((f3d, f2d, torch.cat(record["intrs"][-K:])))
        # the fake clips' pass, then the real windows' pass
        idx = torch.as_tensor(rng.permutation(K * B).reshape(K, B), device=device)
        fake_losses = posenet_pass([f2d[sel] for sel in idx],
                                   [f3d[sel, pad:pad + 1] for sel in idx])
        real2d, real_starts = sequence_windows(p2.reshape(per_step, L, 16, 2), pad)
        order = torch.as_tensor(rng.permutation(K * B), device=device).reshape(K, B)
        real_losses = posenet_pass([real2d[real_starts[o][:, None] + win] for o in order],
                                   [p3[o][:, None] for o in order])
        loss_fake = float(torch.stack(fake_losses).mean())
        loss_real = float(torch.stack(real_losses).mean())
        for sc in scores:
            record["losses"].append(sc.tolist() + [loss_fake, loss_real])
        if c == 0:
            record["moments"] = first_moments(named, opts)
    record["changes"] = changes(named, start)
    return record
