"""The reference runs of the two cells, from the seed alone.

Each rebuilds what the benchmark hands the program (the seeded weights,
pose pool, bone-length templates, numpy stream and torch generator) and
computes, in plain PyTorch, what the timed path must produce:

* :func:`follow_video` -- the first ``steps`` steps of augmented video
  training, each a chunk of the window's size through the chunk's path
  (re-skin, the GAN iterations, both posenet passes), from the fifth
  iteration of a run on (the generator's first update), and the record the
  check compares: each iteration's losses (the critics' mean real and fake
  scores, the generator's cost, the motion critics' Wasserstein estimates,
  the posenet passes' mean losses), the fake clips with the bone lengths
  and intrinsics that each was made with, the first moments of every
  optimizer after the first step, and every parameter's change after the
  last;
* :func:`synth_rows` -- the rows of given dispatches of bulk synthesis.

``precision`` picks the arithmetic: ``"fp32"`` (the cell's own) or the
controls, ``"tf32"`` for training and ``"fp8"`` for the synthesis trunk.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import pool as pool_mod
from benchmark.reference import geometry as geo
from benchmark.reference import nets, steps
from benchmark.reference.cameras import camera_bank


def leaves(named_nets: dict):
    for net_name, net in named_nets.items():
        for name, p in net.named_parameters():
            yield f"{net_name}.{name}", p


def first_moments(named_nets: dict, optimizers: dict) -> dict:
    """Every parameter's Adam first moment norm, by leaf name (0 for a
    parameter its optimizer has not stepped yet)."""
    state = lambda leaf, p: optimizers[leaf.split(".", 1)[0]].state.get(p, {})
    return {leaf: float(state(leaf, p)["exp_avg"].norm()) if "exp_avg" in state(leaf, p)
            else 0.0 for leaf, p in leaves(named_nets)}


def changes(named_nets: dict, start: dict) -> dict:
    return {leaf: float((p.detach() - start[leaf]).norm()) for leaf, p in leaves(named_nets)}


class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""

    def __init__(self, config: dict, seed_list: list, device):
        make = lambda i: pool_mod.torch_generator(device, seed_list[i])
        self.weights = make(0)
        self.pool = pool_mod.make_pool(config["pool"], make(1))
        self.templates = pool_mod.bone_templates(config["pool"], make(2))
        self.np_rng = np.random.default_rng(seed_list[3])
        self.generator = make(4)


def _build(named: dict, inp: Inputs, device, precision: str) -> None:
    """The reference nets on ``device`` at the seeded weights, in float32
    with TF32 off, or marked to round their product operands to TF32."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"training precision {precision!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for net in named.values():
        net.to(device)
    nets.init_weights(list(named.values()), inp.weights)
    if precision == "tf32":
        nets.use_tf32(named.values())


def _gan_hyper(config: dict) -> dict:
    g = config["gan"]
    return dict(lam=float(g["lambda_gp"]), w3d=g["w3d"], w2d=g["w2d"])


# the check's first step is the fifth iteration of a run, a generator one
FIRST_ITERATION = 4


def sequence_windows(seqs: torch.Tensor, pad: int):
    """Edge-padded sequences (S, L, ...) concatenated, and each centre's
    window start in that concatenation, sequence by sequence."""
    S, L = seqs.shape[:2]
    padded = torch.cat([seqs[:, :1].expand(S, pad, *seqs.shape[2:]), seqs,
                        seqs[:, -1:].expand(S, pad, *seqs.shape[2:])], dim=1)
    starts = (torch.arange(S, device=seqs.device)[:, None] * (L + 2 * pad)
              + torch.arange(L, device=seqs.device)[None]).reshape(-1)
    return padded.reshape(S * (L + 2 * pad), *seqs.shape[2:]), starts


def follow_video(config: dict, traffic: dict, seed_list: list, device, steps_n: int = 3,
                 precision: str = "fp32") -> dict:
    """The first ``steps_n`` steps of the video cell, each
    ``traffic["chunk_batches"]`` iterations."""
    g, p = config["gan"], config["posenet"]
    F = int(np.prod(p["filter_widths"]))
    pad = (F - 1) // 2
    inp = Inputs(config, seed_list, device)
    named = {"gen": nets.Generator(g["gen_dense"], head=F * 35),
             "d3d": nets.Critic3D(g["dis_dense_3d"]), "d2d": nets.Critic2D(g["dis_dense_2d"]),
             "md3d": nets.MotionCritic3D(F, g["video_dis_dense_3d"]),
             "md2d": nets.MotionCritic2D(F, g["video_dis_dense_2d"]),
             "posenet": nets.VideoPoseNet(p["filter_widths"], p["channels"], p["dropout"])}
    _build(named, inp, device, precision)
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
            # the motion critics' Wasserstein estimates follow the generator's cost
            scores.append(torch.cat([s3, s2, gc[None], (m3[:1] - m3[1:]), (m2[:1] - m2[1:])]))
            f3d.append(fc3)
            f2d.append(fc2)
            record["bones"].append(bones)
            record["intrs"].append(intr)
        iteration += K
        f3d, f2d = torch.cat(f3d), torch.cat(f2d)
        record["fakes"].append((f3d, f2d, torch.cat(record["intrs"][-K:])))
        idx = torch.as_tensor(rng.permutation(K * B)[: K * B].reshape(K, B), device=device)
        fake_losses = [steps.video_posenet_steps(model, pos_opt, f2d[sel],
                                                 steps.root_relative(f3d[sel, pad:pad + 1]),
                                                 p["max_norm"], gen_rng, p["playback"])
                       for sel in idx]
        real2d, real_starts = sequence_windows(p2.reshape(per_step, L, 16, 2), pad)
        order = rng.permutation(K * B)[: K * B]
        s2d = real_starts[torch.as_tensor(order, device=device)].reshape(K, B)
        i3 = torch.as_tensor(order, device=device).reshape(K, B)
        real_losses = [steps.video_posenet_steps(model, pos_opt, real2d[a[:, None] + win],
                                                 steps.root_relative(p3[b][:, None]),
                                                 p["max_norm"], gen_rng, p["playback"])
                       for a, b in zip(s2d, i3)]
        loss_fake = float(torch.stack(fake_losses).mean())
        loss_real = float(torch.stack(real_losses).mean())
        for sc in scores:
            record["losses"].append(sc.tolist() + [loss_fake, loss_real])
        if c == 0:
            record["moments"] = first_moments(named, opts)
    record["changes"] = changes(named, start)
    return record


def chunk_seed(seed: int, chunk: int) -> int:
    """The seed of synthesis chunk ``chunk``'s generator."""
    return int(np.random.SeedSequence([seed, chunk]).generate_state(1, np.uint64)[0] % (1 << 63))


def synth_bones(config: dict, seed_list: list, batch: int, device) -> torch.Tensor:
    """(batch, 15) FK-order bone lengths, one person a row, the same for
    every dispatch."""
    g = pool_mod.torch_generator(device, seed_list[1])
    return pool_mod.bone_templates(config["pool"], g, batch)[:, pool_mod.tree_to_fk_order()]


@torch.no_grad()
def synth_rows(config: dict, traffic: dict, seed_list: list, device, samples: list,
               precision: str = "bf16") -> list:
    """For each (chunk, dispatch) of ``samples``: the reference's
    (cam3d, pose2d, intrinsics, scaled bone lengths) of that dispatch."""
    dense = config["gan"]["gen_dense"]
    gen = nets.Generator(dense).to(device)
    nets.init_weights([gen], pool_mod.torch_generator(device, seed_list[0]))
    operand = {"bf16": None, "fp8": steps.fp8_operand}[precision]
    B = traffic["batch"]
    bone_len = synth_bones(config, seed_list, B, device)
    quats, trans, intrs = camera_bank(device)
    out = []
    for chunk, dispatch in samples:
        g = pool_mod.torch_generator(device, chunk_seed(seed_list[4], chunk))
        for _ in range(dispatch + 1):
            noise = torch.randn((B, 128), generator=g, device=device)
            scaler8 = steps.draw_scaler8(B, g)
            cam = torch.randint(0, quats.shape[0], (), generator=g, device=device)
        angles, grot, root = steps.head_to_pose_inputs(steps.trunk_bf16(gen, noise, operand))
        bones = steps.scale_bones(bone_len, scaler8)
        world = geo.fk_world_pose_16(angles, bones, grot, root)
        cam3d = geo.world_to_camera_batch(world, quats[cam][None], trans[cam][None])
        intr = intrs[cam][None].expand(B, 9)
        pose2d = geo.project_to_2d(cam3d, intr)
        out.append((cam3d, pose2d, intr, bones))
    return out
