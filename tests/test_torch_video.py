"""The port's video mode (dhaug_torch/gan/video.py, data/chunked.py,
train/video_runner.py and the video parts of the ops, models, loaders and
posenet passes) against dhaug_tpu on the CPU, on the same seeded numpy
inputs.

As in tests/test_torch_gan.py, every random draw of the GAN steps (noise,
bone scalers, camera, the 12 GP alphas) is injected into both packages and
both sides train with plain SGD, so parameter deltas compare the loss and
gradient composition itself."""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dhaug_torch.data import chunked as t_chunked
from dhaug_torch.gan import video as t_video
from dhaug_torch.gan import wgan as t_wgan
from dhaug_torch.models import convert
from dhaug_torch.models import discriminators as t_disc
from dhaug_torch.models import generator as t_gen
from dhaug_torch.models import posenets as t_pose
from dhaug_torch.ops import augment as t_aug
from dhaug_torch.ops import bones as t_bones
from dhaug_torch.train import posenet as t_train
from dhaug_torch.train import video_runner as t_runner
from dhaug_tpu.data import chunked as j_chunked
from dhaug_tpu.gan import video as j_video
from dhaug_tpu.gan import wgan as j_wgan
from dhaug_tpu.models import discriminators as j_disc
from dhaug_tpu.models import generator as j_gen
from dhaug_tpu.models import posenets as j_pose
from dhaug_tpu.ops import augment as j_aug
from dhaug_tpu.ops import bones as j_bones
from dhaug_tpu.train import posenet as j_train
from dhaug_tpu.train import video_runner as j_runner
from dhaug_tpu.train.state import make_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, B, F = 32, 6, 3
SUBJECTS = ["S1", "S5"]
# SGD step sizes, as in tests/test_torch_gan.py: one update must stay in the
# linear regime.  At this width the fresh critics' gradient penalties reach
# ~8e3 (3D critic) and ~2.4e4 (motion-3D critic, through the KCS cosines),
# ~70-200 for the 2D ones.  Measured over these 3 iterations (worst
# parameter-delta difference): at lr 1e-2 for the generator and 1e-6 for
# every critic, up to 1.9e-5 (generator) and 4.3e-5 (3D critic), and with
# the 3D critics at 1e-7 (generator still 1e-2) up to 1.8e-2, where the
# generator's large steps carry the fakes across a ReLU kink of a critic;
# at the rates below, <= 1.2e-7.
GEN_LR = 1e-3
CRITIC_3D_LR = 1e-7
CRITIC_2D_LR = 1e-6
FWD_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _clips(rng, n, frames=F):
    """Plausible camera-space clips: per clip one set of bone lengths and
    angles drifting a few degrees a frame, 5 m in front of the camera."""
    from dhaug_torch.ops.fk import CANONICAL_BONE_LEN, fk_world_pose_16
    ang = rng.uniform(-30, 30, (n, 1, 33)) + np.cumsum(rng.uniform(-3, 3, (n, frames, 33)), 1)
    rot = rng.uniform(-30, 30, (n, 1, 3)) + np.cumsum(rng.uniform(-3, 3, (n, frames, 3)), 1)
    bl = np.repeat(np.asarray(CANONICAL_BONE_LEN) * rng.uniform(0.9, 1.1, (n, 1, 15)), frames, 1)
    root = np.broadcast_to([0.0, 0.0, 5.0], (n, frames, 3)) + \
        np.cumsum(rng.normal(size=(n, frames, 3)) * 0.01, 1)
    args = [torch.tensor(a.reshape(n * frames, -1), dtype=torch.float32)
            for a in (ang, bl, rot, root)]
    return fk_world_pose_16(*args).numpy().reshape(n, frames, 16, 3)


# ---------------------------------------------------------------------------
# geometry and the motion critics
# ---------------------------------------------------------------------------

def test_time_reverse_flip_intrinsics_and_motion_kcs_match_jax():
    rng = np.random.default_rng(0)
    clip = _clips(rng, 4, frames=5)
    cams = rng.normal(size=(4, 5, 16)).astype(np.float32)
    np.testing.assert_array_equal(t_aug.time_reverse(torch.from_numpy(clip)).numpy(),
                                  np.asarray(j_aug.time_reverse(jnp.asarray(clip))))
    np.testing.assert_array_equal(t_aug.flip_intrinsics(torch.from_numpy(cams)).numpy(),
                                  np.asarray(j_aug.flip_intrinsics(jnp.asarray(cams))))
    for with_lengths in (True, False):
        got = t_bones.kcs_features(torch.from_numpy(clip), with_lengths=with_lengths).numpy()
        want = np.asarray(j_bones.kcs_features(jnp.asarray(clip), with_lengths=with_lengths))
        assert got.shape == (4, 5, 30 if with_lengths else 15)
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)


def _perturbed_init(module, x, seed):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32)
                        * 0.05, params)


@pytest.mark.parametrize("pos,diff", [(True, True), (False, True), (True, False),
                                      (False, False)])
def test_motion_3d_critic_forward_parity(pos, diff):
    clip = _clips(np.random.default_rng(1), 7, frames=5)
    clip = clip - clip[:, :, :1]
    jm = j_disc.MotionFk3DDiscriminator(video_frames=5, dense_dim=W, use_pos_branch=pos,
                                        use_diff_branch=diff)
    params = _perturbed_init(jm, clip, 2)
    port = convert.load_md3d(t_disc.MotionFk3DDiscriminator(5, W, pos, diff), params)
    got = port(torch.from_numpy(clip)).detach().numpy()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(clip)))
    assert got.shape == (7, 1)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)


def test_motion_2d_critic_forward_parity():
    clip = (np.random.default_rng(3).normal(size=(7, 5, 16, 2)) * 0.3).astype(np.float32)
    jm = j_disc.MotionFk2DDiscriminator(video_frames=5, dense_dim=W)
    params = _perturbed_init(jm, clip, 4)
    port = convert.load_md2d(t_disc.MotionFk2DDiscriminator(5, W), params)
    got = port(torch.from_numpy(clip)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params}, jnp.asarray(clip))),
                               atol=FWD_TOL, rtol=0)


def test_video_generator_synthesizes_clips_like_jax():
    """A head of F x 35, one scaler set a clip: the (B, F, 16, 3) clips
    agree; F == 1 keeps the single-frame (B, 16, 3)."""
    rng = np.random.default_rng(5)
    for frames in (F, 1):
        cfg_j = j_gen.GeneratorConfig(dense_dim=W, video_frames=frames)
        gen = j_gen.FkGeneratorNet(cfg_j)
        params = gen.init(jax.random.PRNGKey(6), jnp.zeros((2, 128)))["params"]
        cfg_t = t_gen.GeneratorConfig(dense_dim=W, video_frames=frames)
        port = convert.load_generator(t_gen.FkGeneratorNet(cfg_t), _np_tree(params))
        noise = rng.normal(size=(B, 128)).astype(np.float32)
        bl = rng.uniform(0.15, 0.6, (B, 15)).astype(np.float32)
        s8 = (rng.integers(-200, 200, (B, 8)) / 1000.0).astype(np.float32)
        head_j = gen.apply({"params": params}, jnp.asarray(noise))
        want = np.asarray(j_gen.synthesize_poses(head_j, jnp.asarray(bl), jnp.asarray(s8), cfg_j))
        with torch.no_grad():
            got = t_gen.synthesize_poses(port(torch.from_numpy(noise)), torch.from_numpy(bl),
                                         torch.from_numpy(s8), cfg_t).numpy()
        assert got.shape == ((B, frames, 16, 3) if frames > 1 else (B, 16, 3))
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the GAN steps
# ---------------------------------------------------------------------------

class VideoPair:
    """The same video GAN in both packages: flax params copied into the port."""

    def __init__(self, playback: bool):
        cfg_j = j_gen.GeneratorConfig(dense_dim=W, video_frames=F)
        nets = (j_gen.FkGeneratorNet(cfg_j), j_disc.Fk3DDiscriminator(dense_dim=W),
                j_disc.Fk2DDiscriminator(dense_dim=W),
                j_disc.MotionFk3DDiscriminator(video_frames=F, dense_dim=W),
                j_disc.MotionFk2DDiscriminator(video_frames=F, dense_dim=W))
        shapes = ((2, 128), (2, 16, 3), (2, 16, 2), (2, F, 16, 3), (2, F, 16, 2))
        self.params = [n.init(jax.random.PRNGKey(i), jnp.zeros(s))["params"]
                       for i, (n, s) in enumerate(zip(nets, shapes))]
        lrs = (GEN_LR, CRITIC_3D_LR, CRITIC_2D_LR, CRITIC_3D_LR, CRITIC_2D_LR)
        txs = [optax.sgd(lr) for lr in lrs]
        quats, trans, intrs = j_wgan.camera_bank(SUBJECTS)
        apply = [(lambda n: lambda p, x: n.apply({"params": p}, x))(n) for n in nets]
        self.j = j_video.make_video_steps(*apply[:5], txs[1], txs[2], txs[3], txs[4], txs[0],
                                          cfg_j, j_wgan.GanHyper(), quats, trans, intrs,
                                          playback)
        self.states = [make_state(tx, p) for tx, p in zip(txs, self.params)]

        self.mirrors = [lambda: t_gen.FkGeneratorNet(t_gen.GeneratorConfig(dense_dim=W,
                                                                            video_frames=F)),
                        lambda: t_disc.Fk3DDiscriminator(W), lambda: t_disc.Fk2DDiscriminator(W),
                        lambda: t_disc.MotionFk3DDiscriminator(F, W),
                        lambda: t_disc.MotionFk2DDiscriminator(F, W)]
        self.loads = [convert.load_generator, convert.load_d3d, convert.load_d2d,
                      convert.load_md3d, convert.load_md2d]
        self.t_nets = [load(make(), _np_tree(p))
                       for load, make, p in zip(self.loads, self.mirrors, self.params)]
        opts = [torch.optim.SGD(n.parameters(), lr=lr) for n, lr in zip(self.t_nets, lrs)]
        self.t = t_video.VideoSteps(*self.t_nets, *opts,
                                    t_gen.GeneratorConfig(dense_dim=W, video_frames=F),
                                    t_wgan.GanHyper(), *t_wgan.camera_bank(SUBJECTS),
                                    playback=playback)
        self.quats, self.trans, self.intrs = (np.asarray(x) for x in (quats, trans, intrs))

    def batch(self, rng, cam_row):
        clip3d = _clips(rng, B)
        cam16 = np.concatenate([self.intrs[cam_row], self.quats[cam_row],
                                self.trans[cam_row]]).astype(np.float32)
        clip2d = (rng.normal(size=(B, F, 16, 2)) * 0.3).astype(np.float32)
        return clip3d, np.tile(cam16, (B, 1)), clip2d

    def assert_deltas(self, before, after, which, tol):
        """(after - before) of every leaf of net ``which`` agrees."""
        def snapshot(params):
            m = self.loads[which](self.mirrors[which](), _np_tree(params))
            return {k: v.clone() for k, v in m.state_dict().items()}

        ref_after, ref_before = snapshot(after), snapshot(before)
        worst, moved = 0.0, 0.0
        for k, v in self.t_nets[which].state_dict().items():
            delta_j = ref_after[k] - ref_before[k]
            worst = max(worst, float((v - ref_before[k] - delta_j).abs().max()))
            moved = max(moved, float(delta_j.abs().max()))
        assert moved > 100 * tol, f"net {which}: the update is too small to compare ({moved})"
        assert worst <= tol, f"net {which}: worst parameter-delta difference {worst} > {tol}"


def _draws(rng):
    # GP rows of the 12 updates: the single-frame critics and the per-frame
    # motion-2D critic take B x F rows, the motion-3D critic B
    rows = [B * F, B, B, B * F, B, B] + [B * F] * 6
    return dict(noise=rng.normal(size=(B, 128)).astype(np.float32),
                scaler8=(rng.integers(-200, 200, (B, 8)) / 1000.0).astype(np.float32),
                cam_idx=int(rng.integers(0, 4 * len(SUBJECTS))),
                alphas=[rng.uniform(size=(n, 1)).astype(np.float32) for n in rows])


@pytest.mark.parametrize("playback", [True, False], ids=["playback", "no_playback"])
@pytest.mark.parametrize("use_motion", [True, False], ids=["motion", "no_motion"])
def test_three_iterations_of_critics_and_generator_sgd_parity(use_motion, playback):
    """Critics and then the generator at each of 3 iterations, every draw
    injected: critic deltas <= 1e-6, generator deltas <= 1e-5, the critic
    scores and Wasserstein estimates to 1e-4 of the scores (the penalty to
    1e-4 of itself); the motion critics stay put while
    ``use_motion`` is off."""
    pair = VideoPair(playback)
    rng = np.random.default_rng(7)
    gen_s, d3d_s, d2d_s, md3d_s, md2d_s = pair.states
    for it in range(3):
        clip3d, cam16, clip2d = pair.batch(rng, cam_row=it)
        d = _draws(rng)
        (d3d_s, d2d_s, md3d_s, md2d_s, cam_idx, bone_len, f3d, f2d, intr, m_j) = \
            pair.j.critics_step(d3d_s, d2d_s, md3d_s, md2d_s, gen_s.params,
                                jnp.asarray(clip3d), jnp.asarray(cam16), jnp.asarray(clip2d),
                                jax.random.PRNGKey(it), use_motion=use_motion,
                                noise=jnp.asarray(d["noise"]), scaler8=jnp.asarray(d["scaler8"]),
                                cam_idx=jnp.asarray(d["cam_idx"], jnp.int32),
                                alphas=tuple(jnp.asarray(a) for a in d["alphas"]))
        t_cam, t_bl, t_f3d, t_f2d, t_intr, m_t = pair.t.critics_step(
            torch.from_numpy(clip3d), torch.from_numpy(cam16), torch.from_numpy(clip2d), None,
            use_motion, noise=torch.from_numpy(d["noise"]),
            scaler8=torch.from_numpy(d["scaler8"]), cam_idx=torch.tensor(d["cam_idx"]),
            alphas=[torch.from_numpy(a) for a in d["alphas"]])
        assert int(t_cam) == int(cam_idx)
        assert t_f3d.shape == (B, F, 16, 3) and t_f2d.shape == (B, F, 16, 2)
        np.testing.assert_allclose(t_bl.numpy(), np.asarray(bone_len), atol=1e-6)
        # the fakes of the first iteration differ by FK rounding; later ones
        # also by the generator updates' (<= 1e-5 of the parameters)
        atol = 1e-5 if it == 0 else 1e-4
        np.testing.assert_allclose(t_f3d.numpy(), np.asarray(f3d), atol=atol, rtol=0)
        np.testing.assert_allclose(t_f2d.numpy(), np.asarray(f2d), atol=atol, rtol=0)
        np.testing.assert_array_equal(t_intr.numpy(), np.asarray(intr))
        assert set(m_t) == set(m_j)
        for k in ("3d", "2d", "motion_3d", "motion_2d") if use_motion else ("3d", "2d"):
            scale = max(abs(float(m_j[f"{k}_d_real"])), abs(float(m_j[f"{k}_d_fake"])), 1.0)
            for name in ("d_real", "d_fake", "wasserstein", "gp"):
                if name == "gp":  # a penalty of ~1e3-1e4 is held to its own size
                    scale = max(abs(float(m_j[f"{k}_gp"])), 1.0)
                assert abs(float(m_t[f"{k}_{name}"]) - float(m_j[f"{k}_{name}"])) <= \
                    1e-4 * scale, (it, k, name)

        g = _draws(rng)
        gen_s, gm = pair.j.generator_step(
            gen_s, d3d_s.params, d2d_s.params, md3d_s.params, md2d_s.params, bone_len, cam_idx,
            jax.random.PRNGKey(50 + it), use_motion=use_motion, noise=jnp.asarray(g["noise"]),
            scaler8=jnp.asarray(g["scaler8"]))
        gm_t = pair.t.generator_step(t_bl, t_cam, None, use_motion,
                                     noise=torch.from_numpy(g["noise"]),
                                     scaler8=torch.from_numpy(g["scaler8"]))
        np.testing.assert_allclose(float(gm_t["g_cost"]), float(gm["g_cost"]), rtol=1e-5,
                                   atol=1e-5)

    pair.assert_deltas(pair.params[0], gen_s.params, 0, 1e-5)
    for which, state in ((1, d3d_s), (2, d2d_s)) + (((3, md3d_s), (4, md2d_s))
                                                    if use_motion else ()):
        pair.assert_deltas(pair.params[which], state.params, which, 1e-6)
    if not use_motion:
        for which in (3, 4):
            fresh = pair.loads[which](pair.mirrors[which](), _np_tree(pair.params[which]))
            for k, v in fresh.state_dict().items():
                torch.testing.assert_close(pair.t_nets[which].state_dict()[k], v, atol=0, rtol=0)


def test_gp_granularity_takes_the_penalty_per_frame():
    """critic_step with gp_granularity = F against JAX's make_critic_step
    (SGD deltas <= 1e-6) and against a naive loop over frames computing each
    frame's input-gradient norm on its own."""
    rng = np.random.default_rng(8)
    jm = j_disc.MotionFk2DDiscriminator(video_frames=F, dense_dim=W)
    params = jm.init(jax.random.PRNGKey(9), jnp.zeros((2, F, 16, 2)))["params"]
    real = (rng.normal(size=(B, F, 16, 2)) * 0.3).astype(np.float32)
    fake = (rng.normal(size=(B, F, 16, 2)) * 0.3).astype(np.float32)
    alpha = rng.uniform(size=(B * F, 1)).astype(np.float32)
    lr = 1e-4
    step = j_wgan.make_critic_step(lambda p, x: jm.apply({"params": p}, x), optax.sgd(lr), 10.0,
                                   gp_granularity=F)
    state, m_j = step(make_state(optax.sgd(lr), params), jnp.asarray(real), jnp.asarray(fake),
                      jax.random.PRNGKey(0), alpha=jnp.asarray(alpha))

    port = convert.load_md2d(t_disc.MotionFk2DDiscriminator(F, W), _np_tree(params))
    naive = convert.load_md2d(t_disc.MotionFk2DDiscriminator(F, W), _np_tree(params))
    m_t = t_wgan.critic_step(port, torch.optim.SGD(port.parameters(), lr=lr),
                             torch.from_numpy(real), torch.from_numpy(fake), 10.0,
                             alpha=torch.from_numpy(alpha), gp_granularity=F)
    np.testing.assert_allclose(float(m_t["gp"]), float(m_j["gp"]), rtol=1e-5)
    ref = convert.load_md2d(t_disc.MotionFk2DDiscriminator(F, W), _np_tree(state.params))
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref.state_dict()[k].numpy(), atol=1e-6, err_msg=k)

    # naive: each frame's rows interpolated with its own alpha and its
    # gradient norm taken alone
    a = torch.from_numpy(alpha).reshape(B, F, 1, 1)
    interp = (a * torch.from_numpy(real) + (1 - a) * torch.from_numpy(fake)).requires_grad_(True)
    (grad,) = torch.autograd.grad(naive(interp).sum(), interp)
    norms = [torch.sqrt(torch.sum(grad[b, f] ** 2) + 1e-12) for b in range(B) for f in range(F)]
    gp_naive = torch.mean((torch.stack(norms) - 1.0) ** 2) * 10.0
    np.testing.assert_allclose(float(m_t["gp"]), float(gp_naive), rtol=1e-5)


def test_video_gan_epoch_schedule_and_stream():
    """5 batches from global iteration 3 over a full-window loader: one
    permutation from the loader's own stream, the generator updated at
    iteration 4 only, the scalars under the reference's tags."""
    from dhaug_torch.utils.log import Summary

    pair = VideoPair(playback=True)
    rng = np.random.default_rng(10)
    seq3d = [c for c in _clips(rng, 3, frames=10)]
    seq2d = [(rng.normal(size=(10, 16, 2)) * 0.3).astype(np.float32) for _ in range(3)]
    cams = [np.concatenate([pair.intrs[i], pair.quats[i], pair.trans[i]]).astype(np.float32)
            for i in range(3)]
    loader = t_chunked.ChunkWindows(B, cams, seq3d, seq2d, pad=(F - 1) // 2, full_3d_window=True,
                                    shuffle=True, random_seed=3)
    mirror = np.random.default_rng(3)
    summary = Summary("unused")
    summary.train_iter_num = 3
    fakes = t_video.run_video_gan_epoch(pair.t, loader, B, torch.Generator().manual_seed(1),
                                        summary, use_motion=True)
    mirror.permutation(30)
    assert loader.rng.bit_generator.state == mirror.bit_generator.state
    n = (30 // B) * B
    assert [tuple(x.shape) for x in fakes] == [(n, F, 16, 3), (n, F, 16, 2), (n, F, 9)]
    assert (summary.train_iter_num, summary.train_fakepose_iter_num,
            summary.train_discrim_iter_num) == (8, 1, 5)
    assert set(summary.epoch_scalar_history) == {
        "Fk_d3d_Wasserstein_D", "Fk_d3d_D_real", "Fk_d3d_D_fake", "d2d_Wasserstein_D",
        "d2d_D_real", "d2d_D_fake", "G_cost", "motion_Fk_d3d_Wasserstein_D",
        "motion_d2d_Wasserstein_D"}


# ---------------------------------------------------------------------------
# data: windows, sequences, fetch, re-skin
# ---------------------------------------------------------------------------

def _sequences(rng, lengths=(30, 17, 44)):
    seq3d = [rng.normal(size=(n, 16, 3)).astype(np.float32) for n in lengths]
    seq2d = [rng.normal(size=(n, 16, 2)).astype(np.float32) for n in lengths]
    cams = [rng.normal(size=(16,)).astype(np.float32) for _ in lengths]
    return seq3d, seq2d, cams


@pytest.mark.parametrize("full,shuffle,drop_last", [(False, True, True), (True, True, True),
                                                    (False, False, False)])
def test_chunk_windows_match_jax(full, shuffle, drop_last):
    """Padded concatenations, window and target indices, camera rows and
    every batch of an epoch (the shuffle's stream included) as in
    tests/test_video.py's ChunkWindows cases."""
    seq3d, seq2d, cams = _sequences(np.random.default_rng(11))
    kw = dict(batch_size=7, cams=cams, poses_3d=seq3d, poses_2d=seq2d, pad=4,
              full_3d_window=full, shuffle=shuffle, random_seed=5, drop_last=drop_last)
    t, j = t_chunked.ChunkWindows(**kw), j_chunked.ChunkWindows(**kw)
    names = ["big2d", "big3d", "start2d", "cams", "n_chunks", "window", "num_batches"]
    for name in names + (["start3d"] if full else ["idx3d"]):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    batches_t, batches_j = list(t.next_epoch()), list(j.next_epoch())
    assert len(batches_t) == len(batches_j) == t.num_batches
    for bt, bj in zip(batches_t, batches_j):
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)
    assert t.rng.bit_generator.state == j.rng.bit_generator.state


def test_chunk_windows_reject_unequal_sequences_and_keep_boundaries():
    seq3d = [np.full((5, 16, 3), float(i)) for i in range(2)]
    seq2d = [np.full((5, 16, 2), float(i)) for i in range(2)]
    cw = t_chunked.ChunkWindows(10, None, seq3d, seq2d, pad=3, shuffle=False, drop_last=False)
    _, _, w2d = next(cw.next_epoch())
    assert np.all(w2d[:5] == 0.0) and np.all(w2d[5:] == 1.0)
    with pytest.raises(ValueError, match="sequence 1"):
        t_chunked.ChunkWindows(4, None, seq3d, [seq2d[0], seq2d[1][:4]], pad=1)


def test_unchunked_sequences_and_the_3dhp_split_match_jax():
    seq3d, seq2d, cams = _sequences(np.random.default_rng(12))
    t = list(t_chunked.UnchunkedSequences(cams, seq3d, seq2d, pad=4).next_epoch())
    j = list(j_chunked.UnchunkedSequences(cams, seq3d, seq2d, pad=4).next_epoch())
    assert len(t) == len(j) == 3
    for bt, bj in zip(t, j):
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)
    assert t[0][2].shape == (1, 38, 16, 2)
    assert t_chunked.MPI3D_SEQUENCE_RANGES == j_chunked.MPI3D_SEQUENCE_RANGES
    pose3d = np.arange(2929)[:, None, None] * np.ones((1, 16, 3))
    for a, b in zip(t_chunked.split_mpi3d_sequences(pose3d, pose3d[..., :2]),
                    j_chunked.split_mpi3d_sequences(pose3d, pose3d[..., :2])):
        assert [x.shape for x in a] == [x.shape for x in b]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError, match="2929"):
        t_chunked.split_mpi3d_sequences(np.zeros((2400, 16, 3)), np.zeros((2400, 16, 2)))


def _video_args(jax_side: bool, extra=()):
    from dhaug_torch.train.config import parse_aug_args as t_parse
    from dhaug_tpu.train.config import parse_aug_args as j_parse
    argv = ["--data_root", REPO, "--single_or_multi_train_mode", "multi", "--architecture",
            "3,3", "--batch_size", "64", *extra]
    return (j_parse if jax_side else t_parse)(argv)


@pytest.mark.parametrize("extra", [[], ["--video_over_200mm", "true", "--downsample", "2"]],
                         ids=["all_frames", "over_200mm"])
def test_video_data_preparation_matches_jax(extra):
    """Per-sequence training lists (one 16-float camera record a sequence,
    the --video_over_200mm filter), the training windows and the H36M and
    3DHP evaluation loaders of both posenet kinds."""
    from dhaug_torch.train.data_prep import prepare_data as t_prepare
    from dhaug_tpu.train.data_prep import prepare_data as j_prepare
    t, j = t_prepare(_video_args(False, extra), per_frame_cam=False), \
        j_prepare(_video_args(True, extra), per_frame_cam=False)
    for name in ("poses_train", "poses_train_2d", "cams_train"):
        a, b = getattr(t, name), getattr(j, name)
        assert len(a) == len(b) == 40
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
    for name in ("train_det2d3d", "h36m_test"):
        for field in ("poses_3d", "poses_2d", "cams"):
            np.testing.assert_array_equal(getattr(getattr(t, name), field),
                                          getattr(getattr(j, name), field))
    for net in ("mulit_farme_videopose", "mulit_farme_poseformer"):
        ta = _video_args(False, ["--posenet_name", net] + extra)
        ja = _video_args(True, ["--posenet_name", net] + extra)
        _, t_train, t_h36m, t_mpi, rf = t_runner.video_data_preparation(ta)
        _, j_train, _, j_h36m, j_mpi, j_rf = j_runner.video_data_preparation(ja)
        assert rf == j_rf == 9
        np.testing.assert_array_equal(t_train.big2d, j_train.big2d)
        np.testing.assert_array_equal(t_train.idx3d, j_train.idx3d)
        for lt, lj in ((t_h36m, j_h36m), (t_mpi, j_mpi)):
            assert type(lt).__name__ == type(lj).__name__
            for bt, bj in zip(lt.next_epoch(), lj.next_epoch()):
                for a, b in zip(bt[1:], bj[1:]):
                    np.testing.assert_array_equal(a, b)
        assert t_h36m.eval_sequences[3] == j_h36m.eval_sequences[3]
        got = [(a, len(ld.poses_2d) if hasattr(ld, "poses_2d") else ld.n_chunks)
               for a, ld in t_runner.per_action_eval_loaders(64, t_h36m, 4)]
        want = [(a, len(ld.poses_2d) if hasattr(ld, "poses_2d") else ld.n_chunks)
                for a, ld in j_runner.per_action_eval_loaders(64, j_h36m, 4)]
        assert got == want


@pytest.mark.parametrize("per_frame_cam,with_extrinsics", [(False, True), (False, False),
                                                             (True, True)])
def test_fetch_camera_records_and_motion_filter_match_jax(per_frame_cam, with_extrinsics):
    """fetch's camera-record forms and the --video_over_200mm filter on a
    slowly moving sequence, where the filter keeps only some frames (motion
    counted from the last KEPT frame)."""
    from dhaug_torch.data.loaders import fetch as t_fetch
    from dhaug_tpu.data.loaders import fetch as j_fetch
    rng = np.random.default_rng(20)
    steps = rng.uniform(0.0, 0.12, (50, 1, 1)) * np.ones((1, 16, 3))
    walk = (np.cumsum(steps, 0) + rng.normal(size=(1, 16, 3))).astype(np.float32)
    cams = [{"intrinsic": rng.normal(size=9).astype(np.float32),
             "orientation": rng.normal(size=4).astype(np.float32),
             "translation": rng.normal(size=3).astype(np.float32)} for _ in range(2)]
    dataset = {"S1": {"Walking 1": {"positions_3d": [walk, walk * 0.5], "cameras": cams}}}
    keypoints = {"S1": {"Walking 1": [rng.normal(size=(52, 16, 2)).astype(np.float32)
                                      for _ in range(2)]}}
    kw = dict(stride=2, train=True, with_extrinsics=with_extrinsics,
              per_frame_cam=per_frame_cam, min_motion_mm=200.0)
    p3, p2, cam, act = t_fetch(["S1"], dataset, keypoints, None, **kw)
    q3, q2, qact, qcam = j_fetch(["S1"], dataset, keypoints, None, **kw)
    assert 1 < len(p3[0]) < 25 and len(p3[1]) < len(p3[0])
    for a, b in ((p3, q3), (p2, q2), (cam, qcam)):
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert act == qact


def test_video_reskin_update_matches_jax_and_its_stream():
    """One template draw a sequence, then the loader's seed: the same
    re-skinned windows and the same numpy stream afterwards."""
    rng = np.random.default_rng(13)
    seq3d = [c for c in _clips(rng, 3, frames=23)] + [_clips(rng, 1, frames=9)[0]]
    cams = [np.concatenate([np.abs(rng.normal(size=9)) * 0.1 + [1, 1, 0, 0, 0, 0, 0, 0, 0],
                            rng.normal(size=7)]).astype(np.float32) for _ in seq3d]
    templates = (0.2 + 0.3 * rng.random((5, 15))).astype(np.float32)
    bundle = SimpleNamespace(poses_train=seq3d, cams_train=cams)
    args = SimpleNamespace(batch_size=8, architecture="3,3")
    rng_t, rng_j = np.random.default_rng(123), np.random.default_rng(123)
    t = t_runner.video_reskin_update(args, bundle, templates, rng_t, "cpu")
    j = j_runner.video_reskin_update(args, bundle, templates, rng_j)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state
    assert t.rng.bit_generator.state == j.rng.bit_generator.state
    assert t.full_3d_window and t.window == 9
    np.testing.assert_allclose(t.big3d, j.big3d, atol=1e-6, rtol=0)
    np.testing.assert_allclose(t.big2d, j.big2d, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.start3d, j.start3d)
    np.testing.assert_array_equal(t.cams, j.cams)


# ---------------------------------------------------------------------------
# posenet passes and evaluation
# ---------------------------------------------------------------------------

def _temporal_pair(strided: bool):
    kw = dict(out_joints=16, channels=16, strided=strided)
    return (j_pose.TemporalPoseNet(filter_widths=(3, 3), dropout=0.0, **kw),
            t_pose.TemporalPoseNet((3, 3), p_dropout=0.0, **kw))


def _trees(model, x, seed):
    v = model.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                   jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: np.abs(np.asarray(a) + rng.normal(size=a.shape)
                                          .astype(np.float32) * 0.1), v.get("batch_stats", {}))
    return _np_tree(v["params"]), stats


def _assert_posenet_state(port, jm, state, tol):
    ref = _temporal_pair(True)[1]
    convert.load_posenet("mulit_farme_videopose", ref, _np_tree(state.params),
                         _np_tree(state.batch_stats))
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), ref.state_dict()[k].numpy(), atol=tol,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("pass_", ["fake_clips", "real_windows"])
def test_video_posenet_passes_sgd_parity(pass_):
    """The MPJPE step with its playback, flip and flip+playback duplicates,
    clipped at global norm 1 and taken with SGD, over one shuffled pass:
    parameters and BatchNorm statistics <= 1e-6, the same permutation."""
    rng = np.random.default_rng(14)
    jm, port = _temporal_pair(True)
    clips = (rng.normal(size=(20, 9, 16, 2)) * 0.4).astype(np.float32)
    params, stats = _trees(jm, clips[:2], 15)
    convert.load_posenet("mulit_farme_videopose", port, params, stats)
    lr = 0.02
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(lr))
    state = make_state(tx, params, stats)
    opt = torch.optim.SGD(port.parameters(), lr=lr)
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    if pass_ == "fake_clips":
        center = (rng.normal(size=(20, 1, 16, 3)) * 0.3).astype(np.float32)
        t_train.train_video_clips(port, opt, torch.from_numpy(clips), torch.from_numpy(center),
                                  rng_t, 6, 1.0, None, flip=True, playback=True)
        idx = jnp.asarray(rng_j.permutation(20)[:18].reshape(3, 6))
        fn = j_train.make_posenet_epoch_fn(jm, tx, criterion="mpjpe", flip=True, playback=True)
        state, _ = fn(state, jnp.asarray(clips), jnp.asarray(center), idx, jax.random.PRNGKey(0))
    else:
        seq3d, seq2d, cams = _sequences(rng, lengths=(9, 13))
        loader = t_chunked.ChunkWindows(6, cams, seq3d, seq2d, pad=4)
        t_train.train_video_windows(port, opt, loader, rng_t, 6, 1.0, None, flip=True,
                                    playback=True)
        order = rng_j.permutation(loader.n_chunks)[:18]
        fn = j_train.make_video_window_epoch_fn(jm, tx, window=9, criterion="mpjpe", flip=True,
                                                playback=True)
        state, _ = fn(state, jnp.asarray(loader.big2d), jnp.asarray(loader.big3d),
                      jnp.asarray(loader.start2d[order].reshape(3, 6)),
                      jnp.asarray(loader.idx3d[order].reshape(3, 6)), jax.random.PRNGKey(0))
    assert rng_t.bit_generator.state == rng_j.bit_generator.state
    _assert_posenet_state(port, jm, state, 1e-6)


def test_whole_sequence_evaluation_matches_jax():
    """The dilated twin on whole edge-padded sequences (bucket-padded, the
    padding masked), sequence-weighted, unflipped and flip-averaged."""
    rng = np.random.default_rng(16)
    jm, port = _temporal_pair(False)
    seq3d, seq2d, _ = _sequences(rng, lengths=(30, 131, 7))
    seq2d = [s * 0.4 for s in seq2d]
    params, stats = _trees(jm, seq2d[0][None, :12], 17)
    convert.load_posenet("mulit_farme_videopose", port, params, stats)
    forward, flip_forward = j_train.make_posenet_eval_step(jm)
    loader = j_chunked.UnchunkedSequences(None, seq3d, seq2d, pad=4)
    for flip in (False, True):
        want = j_train.evaluate_sequences(forward, params, stats,
                                          j_runner._video_eval_batches(loader, 64),
                                          flip_forward=flip_forward if flip else None)
        got = t_runner.evaluate_video(
            port, t_chunked.UnchunkedSequences(None, seq3d, seq2d, pad=4), 64, "cpu", flip)
        for k in ("p1", "p2", "pck", "auc"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=0, err_msg=(flip, k))


def test_windowed_evaluation_matches_jax():
    """Centre-frame windows frame-weighted (the PoseFormer flavour), with a
    remainder batch."""
    rng = np.random.default_rng(18)
    kw = dict(num_frame=9, embed_dim_ratio=8, depth=1, num_heads=2, drop_path_rate=0.0)
    jm, port = j_pose.PoseFormer(**kw), t_pose.PoseFormer(**kw)
    seq3d, seq2d, _ = _sequences(rng, lengths=(30, 17))
    params, stats = _trees(jm, seq2d[0][None, :9], 19)
    convert.load_posenet("mulit_farme_poseformer", port, params, stats)
    forward, flip_forward = j_train.make_posenet_eval_step(jm)
    kw_cw = dict(batch_size=16, cams=None, poses_3d=seq3d, poses_2d=seq2d, pad=4,
                 shuffle=False, drop_last=False)
    for flip in (False, True):
        want = j_train.evaluate(forward, params, stats,
                                j_runner._video_eval_batches(j_chunked.ChunkWindows(**kw_cw), 16),
                                flip_forward=flip_forward if flip else None)
        got = t_runner.evaluate_video(port, t_chunked.ChunkWindows(**kw_cw), 16, "cpu", flip)
        for k in ("p1", "p2", "pck", "auc"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-3, rtol=0, err_msg=(flip, k))
