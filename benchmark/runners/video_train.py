"""Runner of video-mode augmented training: each chunk is K batches of
nine-frame clips through the program's own epoch functions, in the order
of ``python -m dhaug_torch.run_fk_gan --single_or_multi_train_mode
multi``'s epoch after the critics' warm-up: ``video_reskin_update`` on the
chunk's sequences (one bone-length template a sequence, the clip loader),
``run_video_gan_epoch`` with the motion critics on, ``train_video_clips``
on the fake clips, ``train_video_windows`` on the real windows.
Evaluation is left out.  Set-up drives the program through the check's
first three chunks; the check drops the program's state and follows them
with the reference (``benchmark/reference/follow.py``)."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark import checks
from benchmark.reference import follow
from benchmark.reference import geometry as geo
from benchmark.reference.nets import init_weights
from dhaug_torch.data.chunked import ChunkWindows
from dhaug_torch.gan.video import build_video_gan, run_video_gan_epoch
from dhaug_torch.models.factory import make_posenet, receptive_field
from dhaug_torch.train.config import parse_aug_args
from dhaug_torch.train.posenet import train_video_clips, train_video_windows
from dhaug_torch.train.state import adam_posenet
from dhaug_torch.train.video_runner import video_reskin_update
from dhaug_torch.utils.log import Summary

CHECK_STEPS = 3
SCORES = ("Fk_d3d_D_real", "Fk_d3d_D_fake", "d2d_D_real", "d2d_D_fake", "G_cost",
          "motion_Fk_d3d_Wasserstein_D", "motion_d2d_Wasserstein_D")
# the loss records' indices by what computes them
TERMS = {"critic3d": (0, 1), "critic2d": (2, 3), "generator": (4,), "motion": (5, 6),
         "posenet": (7, 8)}


class Recorder:
    """A writer for the program's GAN epoch: keeps the last epoch's
    per-iteration scalars, {tag: {iteration: value}}."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag: str, value, step: int) -> None:
        self.scalars.setdefault(tag.rsplit("/", 1)[-1], {})[int(step)] = float(value)

    def losses(self, tags, first: int, n: int) -> list:
        """Per iteration ``first`` .. ``first + n - 1``: each tag's value,
        NaN where the epoch wrote none (the generator's cost off its
        iterations)."""
        return [[self.scalars.get(t, {}).get(first + b, float("nan")) for t in tags]
                for b in range(n)]


def take(state: dict, n: int, total: int) -> slice:
    """The next ``n`` of ``total`` rows (or sequences), wrapping to the
    start when they would run past the end."""
    if state["cursor"] + n > total:
        state["cursor"] = 0
    rows = slice(state["cursor"], state["cursor"] + n)
    state["cursor"] += n
    return rows



def build(run, config: dict) -> dict:
    """The program's nets and optimizers."""
    args = parse_aug_args(config["argv"])
    torch.manual_seed(run.seeds[0])
    frames = receptive_field(args.architecture)
    gan = build_video_gan(args, config["train_subjects"], frames, run.device)
    posenet = make_posenet(args.posenet_name, flag="train", stages=args.stages,
                           dropout=args.dropout, architecture=args.architecture).to(run.device)
    named = {"gen": gan.gen, "d3d": gan.d3d, "d2d": gan.d2d, "md3d": gan.md3d,
             "md2d": gan.md2d, "posenet": posenet}
    opts = {"gen": gan.gen_opt, "d3d": gan.d3d_opt, "d2d": gan.d2d_opt, "md3d": gan.md3d_opt,
            "md2d": gan.md2d_opt, "posenet": adam_posenet(posenet.parameters(), args.lr_p)}
    return {"args": args, "gan": gan, "named": named, "opts": opts, "frames": frames}


def setup(run, config: dict, traffic: dict) -> dict:
    """The program's state at the seeded weights, driven through the first
    steps (the check's record), which are chunks at the window's size.  The
    pool is also kept on the host, where the program's clip loader reads
    its sequences."""
    state = build(run, config)
    inp = follow.Inputs(config, run.seeds, run.device)
    init_weights(list(state["named"].values()), inp.weights)
    p = inp.pool
    state.update(inputs=inp, templates=inp.templates.cpu().numpy(), summary=Summary(None),
                 recorder=Recorder(), cursor=0, traffic=traffic, config=config,
                 host=(p.cam3d.cpu().numpy(), p.pose2d.cpu().numpy(), p.cam16.cpu().numpy()))
    state["record"] = first_steps(state, run)
    return state


def chunk(state: dict, run) -> dict:
    """The traffic's chunk of batches of clips through the epoch's functions; each iteration's losses, the fake clips the GAN
    epoch returned and the work done."""
    args, gan, inp, summary = state["args"], state["gan"], state["inputs"], state["summary"]
    B, K = state["traffic"]["batch"], state["traffic"]["chunk_batches"]
    L = inp.pool.sequence_frames
    seqs = take(state, K * B // L, inp.pool.n_sequences)
    h3, h2, hc = state["host"]
    frames = [slice(s * L, (s + 1) * L) for s in range(seqs.start, seqs.stop)]
    bundle = SimpleNamespace(poses_train=[h3[f] for f in frames],
                             poses_train_2d=[h2[f] for f in frames],
                             cams_train=[hc[f.start] for f in frames])
    rng, F, rec = inp.np_rng, state["frames"], state["recorder"]
    pad = (F - 1) // 2
    with run.span("reskin"):
        loader = video_reskin_update(args, bundle, state["templates"], rng, run.device)
    rec.scalars, first = {}, summary.train_iter_num
    with run.span("gan"):
        f3d, f2d, intr = run_video_gan_epoch(gan, loader, B, inp.generator, summary, True, rec)
    posenet, opt = state["named"]["posenet"], state["opts"]["posenet"]
    max_norm = 1.0 if args.max_norm else 1e9
    with run.span("posenet"):
        loss_fake = train_video_clips(posenet, opt, f2d, f3d[:, pad:pad + 1], rng, B, max_norm,
                                      inp.generator, args.flip_pos_model_input,
                                      args.GAN_video_playback_input)
        real = ChunkWindows(B, bundle.cams_train, bundle.poses_train, bundle.poses_train_2d,
                            pad=pad, full_3d_window=False, shuffle=True)
        loss_real = train_video_windows(posenet, opt, real, rng, B, max_norm, inp.generator,
                                        args.flip_pos_model_input, args.Pos_video_playback_input)
    per_batch = lambda playback: (2 if args.flip_pos_model_input else 1) * (2 if playback else 1)
    steps = K * (per_batch(args.GAN_video_playback_input) + per_batch(args.Pos_video_playback_input))
    return {"losses": [row + [loss_fake, loss_real] for row in rec.losses(SCORES, first, K)],
            "fakes": (f3d, f2d, intr),
            "counts": {"units": K, "iterations": K, "clips": K * B, "posenet_steps": steps}}


def first_steps(state: dict, run) -> dict:
    """The program's first steps, each a chunk at the window's size through
    the window's own chunk call, from the fifth iteration of a run on (a
    generator iteration); the record the reference follows."""
    state["summary"].train_iter_num = follow.FIRST_ITERATION
    start = {leaf: p.detach().clone() for leaf, p in follow.leaves(state["named"])}
    record = {"losses": [], "fakes": []}
    for step in range(CHECK_STEPS):
        out = chunk(state, run)
        record["losses"] += out["losses"]
        record["fakes"].append(out["fakes"])
        if step == 0:
            record["moments"] = follow.first_moments(state["named"], state["opts"])
    record["changes"] = follow.changes(state["named"], start)
    return record


def check(state: dict, run) -> dict:
    """Drop the program's state, follow the first steps with the
    reference, and return the gaps."""
    record, config, traffic = state.pop("record"), state["config"], state["traffic"]
    state.clear()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    reference = follow.follow_video(config, traffic, run.seeds, run.device, CHECK_STEPS)
    return checks.training_gaps(record, reference, TERMS, geo.bone_lengths_fk,
                                geo.project_to_2d)


def control(config: dict, traffic: dict, seeds: list, device) -> dict:
    """The control's gaps: the reference with TF32 products in the
    program's place, against the reference."""
    ref = follow.follow_video(config, traffic, seeds, device, CHECK_STEPS)
    low = follow.follow_video(config, traffic, seeds, device, CHECK_STEPS, "tf32")
    return checks.training_gaps(low, ref, TERMS, geo.bone_lengths_fk, geo.project_to_2d)
