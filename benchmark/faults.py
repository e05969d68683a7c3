"""Faults planted in the program underneath a run, to see the check that
decides ``correct`` fail them: the tests drive a run of a tiny cell with one
planted, and ``benchmark.calibrate`` reads them on the card at the cell's
own size, through the same ``harness.run_cell``.

Each fault is ``plant(spec, setattr)``: it replaces attributes of the
program (or of the cell's runner module) through ``setattr(target, name,
value)``, which is pytest's ``monkeypatch.setattr`` or :class:`Patches`'s.
One cell on one card has no exchange between cards to leave out.
"""
from __future__ import annotations

import contextlib

import torch

from benchmark import harness


class Patches(contextlib.AbstractContextManager):
    """``setattr`` that undoes itself on leaving the context."""

    def __init__(self):
        self._undo = []

    def setattr(self, target, name: str, value) -> None:
        self._undo.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def __exit__(self, *exc):
        for target, name, old in reversed(self._undo):
            setattr(target, name, old)
        self._undo.clear()
        return False


def state_unchanged(spec, setattr) -> None:
    """Every optimizer step of the program returns its state unchanged."""
    runner = harness.runner_of(spec)
    setup = runner.setup

    def broken_setup(run, config, traffic):
        with Patches() as p:
            p.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
            return setup(run, config, traffic)

    setattr(runner, "setup", broken_setup)


def _halving(critic_step, only=None):
    """``critic_step`` on the first half of its rows, the mean taken over
    them: every critic's update, or those of the critic types ``only``."""

    def half(critic, opt, real, fake, lambda_gp, generator=None, alpha=None,
             gp_granularity=1):
        if only is None or isinstance(critic, only):
            B = real.shape[0] // 2
            real, fake = real[:B], fake[:B]
        return critic_step(critic, opt, real, fake, lambda_gp, generator, alpha,
                           gp_granularity)

    return half


def half_batch(spec, setattr) -> None:
    """Each critic update takes the mean over the first half of its batch."""
    import dhaug_torch.gan.video as video

    setattr(video, "critic_step", _halving(video.critic_step))


def motion_half_batch(spec, setattr) -> None:
    """Only the two motion critics' updates take the mean over the first
    half of their batch; the single-frame critics are sound."""
    import dhaug_torch.gan.video as video

    motion = (video.MotionFk3DDiscriminator, video.MotionFk2DDiscriminator)
    setattr(video, "critic_step", _halving(video.critic_step, motion))


def altered(spec, setattr) -> None:
    """The FK moves joint 1 of every pose it makes by 1 cm in x."""
    import dhaug_torch.ops.fk_cuda as fk_cuda

    fk = fk_cuda.fk_world_pose_16

    def moved(*args):
        pose = fk(*args).clone()
        pose[:, 1, 0] += 0.01
        return pose

    setattr(fk_cuda, "fk_world_pose_16", moved)


def altered_2d(spec, setattr) -> None:
    """The GAN's projection moves joint 1 of every fake 2D pose it makes by
    0.01 in x."""
    import dhaug_torch.gan.video as video

    project = video.project_to_2d

    def moved(*args):
        pose = project(*args).clone()
        pose[:, 1, 0] += 0.01
        return pose

    setattr(video, "project_to_2d", moved)


def stale_batch(spec, setattr) -> None:
    """From the second iteration of each GAN epoch on, the critics are fed
    the first iteration's clips again, as a prefetch that never advances
    would: iterations 1 and later go wrong, iteration 0 is sound."""
    from dhaug_torch.gan.video import VideoSteps

    runner = harness.runner_of(spec)
    epoch, critics_step = runner.run_video_gan_epoch, VideoSteps.critics_step
    first = []

    def reset(*args, **kwargs):
        first.clear()
        return epoch(*args, **kwargs)

    def stale(self, *args, **kwargs):
        if first:
            args = tuple(first) + args[3:]
        else:
            first.extend(args[:3])
        return critics_step(self, *args, **kwargs)

    setattr(runner, "run_video_gan_epoch", reset)
    setattr(VideoSteps, "critics_step", stale)


def _synth_rows(spec, setattr, alter) -> None:
    runner = harness.runner_of(spec)
    pairs = runner.synth_pairs

    def altered_pairs(*args, **kwargs):
        return alter(*(t.clone() for t in pairs(*args, **kwargs)))

    setattr(runner, "synth_pairs", altered_pairs)


def synth_half(spec, setattr) -> None:
    """Synthesis leaves the second half of each batch's poses at zero."""

    def alter(cam3d, pose2d, intr):
        cam3d[cam3d.shape[0] // 2:] = 0.0
        return cam3d, pose2d, intr

    _synth_rows(spec, setattr, alter)


def synth_altered(spec, setattr) -> None:
    """One synthesized pose has joint 1 moved 1 cm where it is made."""

    def alter(cam3d, pose2d, intr):
        cam3d[0, 1, 0] += 0.01
        return cam3d, pose2d, intr

    _synth_rows(spec, setattr, alter)


def synth_altered_2d(spec, setattr) -> None:
    """One 2D pose has joint 1 moved by 0.01 in x where it is made."""

    def alter(cam3d, pose2d, intr):
        pose2d[0, 1, 0] += 0.01
        return cam3d, pose2d, intr

    _synth_rows(spec, setattr, alter)


def trunk_row(spec, setattr) -> None:
    """The generator trunk's last row of each batch comes out as its first
    row's: one pose of many made from the wrong slot."""
    import dhaug_torch.parallel.sharded as sharded

    trunk = sharded.trunk_forward

    def wrong_slot(ops, noise):
        head = trunk(ops, noise).clone()
        head[-1] = head[0]
        return head

    setattr(sharded, "trunk_forward", wrong_slot)


TRAINING = {"state_unchanged": state_unchanged, "half_batch": half_batch,
            "motion_half_batch": motion_half_batch, "altered": altered,
            "altered_2d": altered_2d, "stale_batch": stale_batch}
SYNTHESIS = {"synth_half": synth_half, "synth_altered": synth_altered,
             "synth_altered_2d": synth_altered_2d, "trunk_row": trunk_row}
BY_RUNNER = {"video_train": TRAINING, "synth": SYNTHESIS}


def of(spec) -> dict:
    """The faults a cell can have, by name."""
    return BY_RUNNER[spec.traffic["runner"]]
