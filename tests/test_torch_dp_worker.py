"""Worker functions of the data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_cuda.py), in a module that the ranks' spawned processes
import by name.  It holds no test.

Each function runs the same way in the test's own process (one device) and
on each rank of ``dhaug_torch.parallel.mesh.launch``: it builds its nets
from the state dicts it is given, takes this rank's rows of the global
inputs, and returns numpy arrays, with whatever spans ranks gathered or
averaged, so a 2-rank result compares directly with the 1-process one.
Imports torch, numpy and dhaug_torch only (no JAX)."""
import copy

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from dhaug_torch.data.chunked import ChunkWindows
from dhaug_torch.data.loaders import PoseDataset, PoseTarget
from dhaug_torch.gan import single_frame, video, wgan
from dhaug_torch.models import discriminators, generator, posenets
from dhaug_torch.ops import fk_cuda
from dhaug_torch.parallel import mesh
from dhaug_torch.train import posenet as train
from dhaug_torch.train.state import adam_gan, adam_posenet
from dhaug_torch.train.video_runner import evaluate_video
from dhaug_torch.utils.log import Summary


def _host(x):
    return x.detach().cpu().numpy()


def _state(module):
    return {k: _host(v) for k, v in module.state_dict().items()}


def load_state(module, sd):
    module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return module


def _mean(x):
    return float(mesh.current().mean(torch.as_tensor(x, dtype=torch.float32)))


def gan_nets(width, frames, sds, device="cpu"):
    """The generator and critics at ``width`` (with the motion critics when
    ``frames`` > 1), loaded from ``sds`` when given, else seeded."""
    torch.manual_seed(0)
    nets = [generator.FkGeneratorNet(generator.GeneratorConfig(dense_dim=width,
                                                               video_frames=frames)),
            discriminators.Fk3DDiscriminator(width), discriminators.Fk2DDiscriminator(width)]
    if frames > 1:
        nets += [discriminators.MotionFk3DDiscriminator(frames, width),
                 discriminators.MotionFk2DDiscriminator(frames, width)]
    if sds is not None:
        nets = [load_state(n, sd) for n, sd in zip(nets, sds)]
    return [n.to(device) for n in nets]


def _single_frame_steps(width, sds, opt, subjects, device="cpu"):
    gen, d3d, d2d = gan_nets(width, 1, sds, device)
    return wgan.SingleFrameSteps(gen, d3d, d2d, opt(gen), opt(d3d), opt(d2d),
                                 generator.GeneratorConfig(dense_dim=width), wgan.GanHyper(),
                                 *wgan.camera_bank(subjects, device))


def gan_step_phases(width, subjects, critic_sds, critic_lr, gen_sds, gen_lr, batch, draws,
                    gen_inputs, device="cpu"):
    """One critic phase on ``batch`` (real cam-3D, cam16, target 2D; global
    rows) with the injected global ``draws``, and, on nets of their own, one
    generator update on ``gen_inputs`` (bone lengths, camera, noise,
    scaler8), both with SGD.  Returns the critics' and the generator's
    weights after, the gathered fakes and bone lengths, and the scalars
    averaged over the ranks."""
    dp = mesh.current()
    t = lambda x: torch.as_tensor(x, device=device)
    sgd = lambda lr: lambda m: torch.optim.SGD(m.parameters(), lr=lr)
    steps = _single_frame_steps(width, critic_sds, sgd(critic_lr), subjects, device)
    real, cam16, tgt2d = (dp.rows(t(x)) for x in batch)
    cam_idx, bone_len, f3d, f2d, intr, metrics = steps.critics_step(
        real, cam16, tgt2d, None, noise=t(draws["noise"]), scaler8=t(draws["scaler8"]),
        cam_idx=torch.tensor(draws["cam_idx"]), alphas=[t(a) for a in draws["alphas"]])
    out = {"d3d": _state(steps.d3d), "d2d": _state(steps.d2d), "cam_idx": int(cam_idx),
           "metrics": {k: _mean(v) for k, v in metrics.items()}}
    out.update({k: _host(dp.all_gather_rows(v))
                for k, v in (("bone_len", bone_len), ("fake3d", f3d), ("fake2d", f2d),
                             ("intr", intr))})
    g_steps = _single_frame_steps(width, gen_sds, sgd(gen_lr), subjects, device)
    gm = g_steps.generator_step(dp.rows(t(gen_inputs["bone_len"])),
                                torch.tensor(gen_inputs["cam_idx"]), None,
                                noise=t(gen_inputs["noise"]), scaler8=t(gen_inputs["scaler8"]))
    out.update(gen=_state(g_steps.gen), g_cost=_mean(gm["g_cost"]),
               launches=mesh.kernel_launches())
    # B1 on this rank's rows of a global batch (noise columns as degrees and root)
    noise = t(draws["noise"])
    fk_args = (noise[:, :33] * 30.0, t(gen_inputs["bone_len"]), noise[:, 33:36] * 30.0,
               noise[:, 36:39])
    out["fk_rows"] = _host(dp.all_gather_rows(
        fk_cuda.fk_world_pose_16(*(dp.rows(a).contiguous() for a in fk_args))))
    return out


def video_step_phases(width, frames, subjects, sds, lrs, batch, draws, gen_inputs):
    """The video twin of :func:`gan_step_phases` with the motion critics on
    and playback: one critic phase (real clips, cam16, 2D clips; the 12
    injected GP draws), then one generator update on the updated nets,
    every net with SGD at its rate in ``lrs``."""
    dp = mesh.current()
    t = torch.as_tensor
    nets = gan_nets(width, frames, sds)
    opts = [torch.optim.SGD(n.parameters(), lr=lr) for n, lr in zip(nets, lrs)]
    steps = video.VideoSteps(*nets, *opts,
                             generator.GeneratorConfig(dense_dim=width, video_frames=frames),
                             wgan.GanHyper(), *wgan.camera_bank(subjects), playback=True)
    real, cam16, real2d = (dp.rows(t(x)) for x in batch)
    cam_idx, bone_len, f3d, f2d, _, metrics = steps.critics_step(
        real, cam16, real2d, None, True, noise=t(draws["noise"]),
        scaler8=t(draws["scaler8"]), cam_idx=torch.tensor(draws["cam_idx"]),
        alphas=[t(a) for a in draws["alphas"]])
    critics = [_state(n) for n in nets[1:]]
    gm = steps.generator_step(bone_len, cam_idx, None, True, noise=t(gen_inputs["noise"]),
                              scaler8=t(gen_inputs["scaler8"]))
    return {"critics": critics, "gen": _state(nets[0]), "g_cost": _mean(gm["g_cost"]),
            "metrics": {k: _mean(v) for k, v in metrics.items()},
            "fake3d": _host(dp.all_gather_rows(f3d)), "fake2d": _host(dp.all_gather_rows(f2d))}


class ScalarLog:
    """A writer that keeps the per-iteration scalars: {tag: {step: value}}."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, {})[int(step)] = float(value)


class GradientLog:
    """Each parameter's largest gradient magnitude, element by element, over
    the optimizer steps taken from its making to :meth:`remove` (an
    optimizer step pre-hook reads ``p.grad`` as the step will use it)."""

    def __init__(self):
        self.max_abs = {}
        self.handle = register_optimizer_step_pre_hook(self._hook)

    def _hook(self, opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    g = p.grad.detach().abs()
                    prev = self.max_abs.get(id(p))
                    self.max_abs[id(p)] = g.clone() if prev is None else torch.maximum(prev, g)

    def remove(self):
        self.handle.remove()

    def of(self, module):
        """{parameter name: largest |gradient| array} of ``module``."""
        return {k: _host(self.max_abs[id(p)]) for k, p in module.named_parameters()
                if id(p) in self.max_abs}


def gan_epoch(mode, width, frames, subjects, data, batch_size, seed):
    """One GAN epoch with Adam from seeded nets: single-frame
    (``run_gan_epoch`` over ``data`` = (cam-3D, 2D, cam16) frames) or video
    (``run_video_gan_epoch`` over a full-window loader of ``data`` = (clip
    sequences 3D, 2D, cams)), from global iteration 0.  Returns
    every net's weights, the epoch's per-iteration and per-epoch scalars,
    the fake buffers and each weight's largest gradient (the ranks' mean,
    :class:`GradientLog`) over the epoch's steps."""
    nets = gan_nets(width, frames, None)
    opts = [adam_gan(n.parameters()) for n in nets]
    cfg = generator.GeneratorConfig(dense_dim=width, video_frames=frames)
    cams = wgan.camera_bank(subjects)
    mesh.current().broadcast_modules(*nets)
    summary = Summary(None)
    log = ScalarLog()
    g = torch.Generator().manual_seed(seed)
    grads = GradientLog()
    if mode == "single":
        steps = wgan.SingleFrameSteps(*nets, *opts, cfg, wgan.GanHyper(), *cams)
        p3d, p2d, cam16 = data
        ds = PoseDataset(p3d, p2d, cam16)
        fakes = single_frame.run_gan_epoch(steps, ds, PoseTarget(p2d), PoseTarget(p3d),
                                           batch_size, np.random.default_rng(seed), g, summary,
                                           log)
        fakes = (fakes.poses_3d, fakes.poses_2d, fakes.cams)
    else:
        steps = video.VideoSteps(*nets, *opts, cfg, wgan.GanHyper(), *cams, playback=True)
        seq3d, seq2d, seq_cams = data
        loader = ChunkWindows(batch_size, seq_cams, seq3d, seq2d, pad=(frames - 1) // 2,
                              full_3d_window=True, shuffle=True, random_seed=seed)
        fakes = video.run_video_gan_epoch(steps, loader, batch_size, g, summary,
                                          use_motion=True, writer=log)
    grads.remove()
    return {"nets": [_state(n) for n in nets], "fakes": [_host(f) for f in fakes],
            "scalars": log.scalars, "epoch_scalars": summary.epoch_scalar_history,
            "grad_max_abs": [grads.of(n) for n in nets]}


def _eval_scores(model, p2d, p3d, batch_sizes):
    return {f"{bs}_{flip}": train.evaluate(model, p2d, p3d, bs, flip=flip)
            for bs in batch_sizes for flip in (False, True)}


def traditional_epoch(pool, subjects, n_poses, batch_size, seed):
    """The ``normal`` mode's epoch: the random-FK augmenter run whole on
    this process from the seeded generator (as the JAX package runs it on
    every device), its poses seen through every camera, then one flipped
    posenet pass over them (the MLP of :func:`posenet_epochs`), each rank
    on its rows.  Returns the fakes, the pass's loss and the weights."""
    from dhaug_torch.gan.traditional import (TraditionalConfig, generate_traditional_poses,
                                             project_through_cameras)
    g = torch.Generator().manual_seed(seed)
    pose16, *_ = generate_traditional_poses(g, torch.as_tensor(pool),
                                            TraditionalConfig(n_poses=n_poses))
    cam3d, pose2d = project_through_cameras(pose16, *wgan.camera_bank(subjects))
    torch.manual_seed(0)
    mlp = posenets.LinearModel(linear_size=64, num_stage=1, p_dropout=0.25)
    mesh.current().broadcast_modules(mlp)
    loss = train.train_epoch(mlp, adam_posenet(mlp.parameters(), 1e-4), pose2d, cam3d,
                             np.random.default_rng(seed), batch_size, 1.0, g, flip=True)
    return {"fakes": [_host(cam3d), _host(pose2d)], "loss": loss, "mlp": _state(mlp)}


def posenet_epochs(frames_data, eval_data, windows_data, batch_size, seed, eval_batch_sizes):
    """The MLP of tests/test_parallel.py:292-333 (64 wide, 1 stage, batch
    norm, dropout 0.25, Adam at 1e-4): its evaluation on ``eval_data`` at
    ``eval_batch_sizes`` before training, the batch-norm statistics of one
    train-mode forward of the first global batch, one flipped
    ``train_epoch`` on ``frames_data`` and its eval-mode predictions on the
    probe after; then a multi-frame VideoPose (3, 3), 32 channels, on the
    centre-frame windows of ``windows_data``: its windowed evaluation, one
    ``train_video_windows`` pass with playback and flip, its predictions
    after."""
    dp = mesh.current()
    p2d, p3d, probe = frames_data
    torch.manual_seed(0)
    mlp = posenets.LinearModel(linear_size=64, num_stage=1, p_dropout=0.25)
    dp.broadcast_modules(mlp)
    out = {"mlp_eval": _eval_scores(mlp, *eval_data, eval_batch_sizes)}
    probe_net = copy.deepcopy(mlp).train()
    probe_net(dp.rows(torch.as_tensor(p2d[:batch_size])), torch.Generator().manual_seed(seed))
    out["bn_first_batch"] = {k: v for k, v in _state(probe_net).items() if "running" in k}
    g = torch.Generator().manual_seed(seed)
    loss = train.train_epoch(mlp, adam_posenet(mlp.parameters(), 1e-4), p2d, p3d,
                             np.random.default_rng(seed), batch_size, 1.0, g, flip=True)
    mlp.eval()
    with torch.no_grad():
        out["mlp_pred"] = _host(mlp(torch.as_tensor(probe)))
    out.update(mlp_loss=loss, mlp=_state(mlp))

    seq3d, seq2d = windows_data
    torch.manual_seed(1)
    vp = posenets.TemporalPoseNet((3, 3), channels=32, p_dropout=0.25)
    dp.broadcast_modules(vp)
    loader = ChunkWindows(batch_size, None, seq3d, seq2d, pad=4, shuffle=False,
                          drop_last=False)
    out["video_eval"] = evaluate_video(vp, loader, batch_size, "cpu", flip=True)
    train_loader = ChunkWindows(batch_size, None, seq3d, seq2d, pad=4)
    out["video_loss"] = train.train_video_windows(
        vp, adam_posenet(vp.parameters(), 1e-4), train_loader, np.random.default_rng(seed),
        batch_size, 1.0, g, flip=True, playback=True)
    vp.eval()
    with torch.no_grad():
        windows = np.stack([s[:9] for s in seq2d])
        out["video_pred"] = _host(vp(torch.as_tensor(windows)))
    out["video"] = _state(vp)
    return out
