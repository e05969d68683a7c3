"""dhaug_torch WGAN-GP steps and epoch plumbing against dhaug_tpu (CPU).

Every random draw (noise, bone scalers, camera, GP alphas) is injected into
both packages, and both sides train with plain SGD, so the parameter deltas
compare the loss and gradient composition itself (Adam would rescale
near-zero gradients to O(lr) and hide it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dhaug_torch.data.loaders import PoseDataset as TPoseDataset
from dhaug_torch.data.loaders import PoseTarget as TPoseTarget
from dhaug_torch.gan import single_frame as t_sf
from dhaug_torch.gan import wgan as t_wgan
from dhaug_torch.models import convert
from dhaug_torch.models import discriminators as t_disc
from dhaug_torch.models import generator as t_gen
from dhaug_tpu.data.loaders import PoseDataset as JPoseDataset
from dhaug_tpu.gan import single_frame as j_sf
from dhaug_tpu.gan import wgan as j_wgan
from dhaug_tpu.models import discriminators as j_disc
from dhaug_tpu.models import generator as j_gen
from dhaug_tpu.train.state import make_state

W = 32
B = 24
# SGD step sizes.  At this width the fresh 3D critic's gradient-penalty
# gradients reach ~1e4, so its step is kept small enough that one update
# moves weights by ~0.01 and stays in the linear regime; the generator's
# gradients are O(1).
CRITIC_LR = 1e-6
GEN_LR = 1e-2
SUBJECTS = ["S1", "S5"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class Pair:
    """The same GAN in both packages: flax params copied into the port."""

    def __init__(self, flip=True, lr=CRITIC_LR):
        gen = j_gen.FkGeneratorNet(j_gen.GeneratorConfig(dense_dim=W))
        d3d = j_disc.Fk3DDiscriminator(dense_dim=W)
        d2d = j_disc.Fk2DDiscriminator(dense_dim=W)
        self.gp = gen.init(jax.random.PRNGKey(0), jnp.zeros((2, 128)))["params"]
        self.p3 = d3d.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 3)))["params"]
        self.p2 = d2d.init(jax.random.PRNGKey(2), jnp.zeros((2, 16, 2)))["params"]
        self.txs = [optax.sgd(lr) for _ in range(3)]
        quats, trans, intrs = j_wgan.camera_bank(SUBJECTS)
        self.j = j_wgan.make_single_frame_steps(
            lambda p, x: gen.apply({"params": p}, x),
            lambda p, x: d3d.apply({"params": p}, x),
            lambda p, x: d2d.apply({"params": p}, x),
            self.txs[0], self.txs[1], self.txs[2],
            j_gen.GeneratorConfig(dense_dim=W), j_wgan.GanHyper(flip=flip),
            quats, trans, intrs)
        self.gen_s = make_state(self.txs[2], self.gp)
        self.d3d_s = make_state(self.txs[0], self.p3)
        self.d2d_s = make_state(self.txs[1], self.p2)

        self.tgen = convert.load_generator(
            t_gen.FkGeneratorNet(t_gen.GeneratorConfig(dense_dim=W)), _np_tree(self.gp))
        self.td3d = convert.load_d3d(t_disc.Fk3DDiscriminator(W), _np_tree(self.p3))
        self.td2d = convert.load_d2d(t_disc.Fk2DDiscriminator(W), _np_tree(self.p2))
        sgd = lambda m: torch.optim.SGD(m.parameters(), lr=lr)
        self.t = t_wgan.SingleFrameSteps(
            self.tgen, self.td3d, self.td2d, sgd(self.tgen), sgd(self.td3d), sgd(self.td2d),
            t_gen.GeneratorConfig(dense_dim=W), t_wgan.GanHyper(flip=flip),
            *t_wgan.camera_bank(SUBJECTS))
        self.quats, self.trans, self.intrs = (np.asarray(x) for x in (quats, trans, intrs))


def _real_poses(rng, n):
    """Plausible camera-space poses: the DH skeleton at moderate random
    angles and bone lengths, 5 m in front of the camera."""
    from dhaug_torch.ops.fk import CANONICAL_BONE_LEN, fk_world_pose_16
    args = (rng.uniform(-30, 30, (n, 33)),
            np.asarray(CANONICAL_BONE_LEN) * rng.uniform(0.9, 1.1, (n, 15)),
            rng.uniform(-30, 30, (n, 3)), np.broadcast_to([0.0, 0.0, 5.0], (n, 3)))
    return fk_world_pose_16(*[torch.tensor(a, dtype=torch.float32) for a in args]).numpy()


def _batch(rng, pair, cam_row=3):
    real = _real_poses(rng, B)
    cam16 = np.concatenate([np.broadcast_to(pair.intrs[cam_row], (B, 9)),
                            np.broadcast_to(pair.quats[cam_row], (B, 4)),
                            np.broadcast_to(pair.trans[cam_row], (B, 3))], axis=1)
    tgt2d = (rng.normal(size=(B, 16, 2)) * 0.3).astype(np.float32)
    return real, cam16.astype(np.float32), tgt2d


def _draws(rng):
    return dict(noise=rng.normal(size=(B, 128)).astype(np.float32),
                scaler8=(rng.integers(-200, 200, (B, 8)) / 1000.0).astype(np.float32),
                cam_idx=int(rng.integers(0, 4 * len(SUBJECTS))),
                alphas=[rng.uniform(size=(B, 1)).astype(np.float32) for _ in range(4)])


def _jax_draws(d):
    return dict(noise=jnp.asarray(d["noise"]), scaler8=jnp.asarray(d["scaler8"]),
                cam_idx=jnp.asarray(d["cam_idx"], jnp.int32),
                alphas=tuple(jnp.asarray(a) for a in d["alphas"]))


def _torch_draws(d):
    return dict(noise=torch.from_numpy(d["noise"]), scaler8=torch.from_numpy(d["scaler8"]),
                cam_idx=torch.tensor(d["cam_idx"]),
                alphas=[torch.from_numpy(a) for a in d["alphas"]])


def _assert_delta(load, module, before_j, after_j, tol, what):
    """(after - before) of every leaf agrees between the packages."""
    mirror = type(module)(W) if not isinstance(module, t_gen.FkGeneratorNet) else \
        t_gen.FkGeneratorNet(t_gen.GeneratorConfig(dense_dim=W))

    def snapshot(params):
        load(mirror, _np_tree(params))
        return {k: v.clone() for k, v in mirror.state_dict().items()}

    ref_after, ref_before = snapshot(after_j), snapshot(before_j)
    worst, moved = 0.0, 0.0
    for k, v in module.state_dict().items():
        delta_j = ref_after[k] - ref_before[k]
        delta_t = v - ref_before[k]
        worst = max(worst, float((delta_t - delta_j).abs().max()))
        moved = max(moved, float(delta_j.abs().max()))
    assert moved > 100 * tol, f"{what}: the update is too small to compare ({moved})"
    assert worst <= tol, f"{what}: worst parameter-delta difference {worst} > {tol}"
    return worst


def test_critics_step_sgd_parity():
    pair = Pair()
    rng = np.random.default_rng(0)
    real, cam16, tgt2d = _batch(rng, pair)
    d = _draws(rng)
    (d3d_s, d2d_s, cam_idx, bone_len, f3d, f2d, intr, m_j) = pair.j.critics_step(
        pair.d3d_s, pair.d2d_s, pair.gen_s.params, jnp.asarray(real), jnp.asarray(cam16),
        jnp.asarray(tgt2d), jax.random.PRNGKey(9), **_jax_draws(d))
    out = pair.t.critics_step(torch.from_numpy(real), torch.from_numpy(cam16),
                              torch.from_numpy(tgt2d), None, **_torch_draws(d))
    t_cam, t_bl, t_f3d, t_f2d, t_intr, m_t = out
    assert int(t_cam) == int(cam_idx)
    np.testing.assert_allclose(t_bl.numpy(), np.asarray(bone_len), atol=1e-6)
    np.testing.assert_allclose(t_f3d.numpy(), np.asarray(f3d), atol=1e-5)
    np.testing.assert_allclose(t_f2d.numpy(), np.asarray(f2d), atol=1e-5)
    np.testing.assert_allclose(t_intr.numpy(), np.asarray(intr), atol=0)
    for k, v in m_j.items():
        np.testing.assert_allclose(float(m_t[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    _assert_delta(convert.load_d3d, pair.td3d, pair.p3, d3d_s.params, 1e-6, "d3d")
    _assert_delta(convert.load_d2d, pair.td2d, pair.p2, d2d_s.params, 1e-6, "d2d")


def test_generator_step_sgd_parity():
    pair = Pair(lr=GEN_LR)
    rng = np.random.default_rng(1)
    bone_len = rng.uniform(0.15, 0.6, (B, 15)).astype(np.float32)
    d = _draws(rng)
    gen_s, gm = pair.j.generator_step(
        pair.gen_s, pair.p3, pair.p2, jnp.asarray(bone_len),
        jnp.asarray(d["cam_idx"], jnp.int32), jax.random.PRNGKey(3),
        noise=jnp.asarray(d["noise"]), scaler8=jnp.asarray(d["scaler8"]))
    m_t = pair.t.generator_step(torch.from_numpy(bone_len), torch.tensor(d["cam_idx"]), None,
                                noise=torch.from_numpy(d["noise"]),
                                scaler8=torch.from_numpy(d["scaler8"]))
    np.testing.assert_allclose(float(m_t["g_cost"]), float(gm["g_cost"]), rtol=1e-5, atol=1e-6)
    _assert_delta(convert.load_generator, pair.tgen, pair.gp, gen_s.params, 1e-5, "generator")
    # the critics are not touched by the generator update
    ref = t_disc.Fk3DDiscriminator(W)
    convert.load_d3d(ref, _np_tree(pair.p3))
    for k, v in ref.state_dict().items():
        torch.testing.assert_close(pair.td3d.state_dict()[k], v, atol=0, rtol=0)


def test_six_iterations_track_the_wasserstein_curve():
    """Critics every iteration, the generator at iteration 4, all draws
    injected: the two packages' critic curves agree to rtol 1e-3.

    The Wasserstein estimate D(real) - D(fake) can be a near-cancelling
    difference (a 3D value of -0.077 from scores near -2 was measured), so
    its tolerance is rtol 1e-3 of the critic scores it is the difference of,
    as well as of itself."""
    pair = Pair()
    rng = np.random.default_rng(2)
    d3d_s, d2d_s, gen_s = pair.d3d_s, pair.d2d_s, pair.gen_s
    keys = ("3d_d_real", "3d_d_fake", "3d_wasserstein", "2d_d_real", "2d_d_fake",
            "2d_wasserstein")
    curves_j, curves_t = [], []
    for it in range(6):
        real, cam16, tgt2d = _batch(rng, pair, cam_row=it % 4)
        d = _draws(rng)
        (d3d_s, d2d_s, cam_idx, bone_len, _, _, _, m_j) = pair.j.critics_step(
            d3d_s, d2d_s, gen_s.params, jnp.asarray(real), jnp.asarray(cam16),
            jnp.asarray(tgt2d), jax.random.PRNGKey(it), **_jax_draws(d))
        t_cam, t_bl, _, _, _, m_t = pair.t.critics_step(
            torch.from_numpy(real), torch.from_numpy(cam16), torch.from_numpy(tgt2d), None,
            **_torch_draws(d))
        curves_j.append([float(m_j[k]) for k in keys])
        curves_t.append([float(m_t[k]) for k in keys])
        if it % 5 == 4:
            g = _draws(rng)
            gen_s, _ = pair.j.generator_step(
                gen_s, d3d_s.params, d2d_s.params, bone_len, cam_idx, jax.random.PRNGKey(99),
                noise=jnp.asarray(g["noise"]), scaler8=jnp.asarray(g["scaler8"]))
            pair.t.generator_step(t_bl, t_cam, None, noise=torch.from_numpy(g["noise"]),
                                  scaler8=torch.from_numpy(g["scaler8"]))
    cj, ct = np.array(curves_j), np.array(curves_t)
    np.testing.assert_allclose(ct[:, [0, 1, 3, 4]], cj[:, [0, 1, 3, 4]], rtol=1e-3)
    for w, (r, f) in ((2, (0, 1)), (5, (3, 4))):
        scale = np.maximum(np.abs(cj[:, r]), np.abs(cj[:, f]))
        assert np.all(np.abs(ct[:, w] - cj[:, w]) <= 1e-3 * scale), (ct[:, w], cj[:, w])


def test_critics_step_draws_from_the_generator():
    pair = Pair(flip=False)
    rng = np.random.default_rng(3)
    real, cam16, tgt2d = (torch.from_numpy(a) for a in _batch(rng, pair))
    g = torch.Generator().manual_seed(0)
    cam_idx, bl, f3d, f2d, intr, metrics = pair.t.critics_step(real, cam16, tgt2d, g)
    assert 0 <= int(cam_idx) < 4 * len(SUBJECTS)
    assert f3d.shape == (B, 16, 3) and f2d.shape == (B, 16, 2) and intr.shape == (B, 9)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert not any(p.requires_grad for p in (f3d, f2d))


def _pose_dataset(rng, n):
    poses = _real_poses(rng, n)
    cams = np.tile(np.concatenate([[1.1, 1.1, 0.01, -0.02, -0.2, 0.24, 0.0, 0.0, 0.0],
                                   [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]), (n, 1))
    return poses, np.zeros((n, 16, 2), np.float32), cams.astype(np.float32)


def test_reskin_dataset_matches_and_consumes_the_numpy_stream_alike():
    templates = np.load("data_extra/bone_length_npy/hm36s15678_bl_templates.npy")
    poses, p2d, cams = _pose_dataset(np.random.default_rng(4), 300)
    rng_j, rng_t = np.random.default_rng(11), np.random.default_rng(11)
    out_j = j_sf.reskin_dataset(JPoseDataset(poses, p2d, cams), templates, rng_j)
    out_t = t_sf.reskin_dataset(TPoseDataset(poses, p2d, cams), templates, rng_t, "cpu")
    np.testing.assert_allclose(out_t.poses_3d.numpy(), np.asarray(out_j.poses_3d), atol=1e-6)
    np.testing.assert_allclose(out_t.poses_2d.numpy(), np.asarray(out_j.poses_2d), atol=1e-6)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state
    assert rng_t.integers(0, 1 << 30) == rng_j.integers(0, 1 << 30)


def test_run_gan_epoch_schedule_and_stream():
    """3 batches from global iteration 3: the generator updates once (at
    iteration 4); the epoch draws exactly two permutations."""
    from dhaug_torch.utils.log import Summary

    pair = Pair(flip=False)
    poses, p2d, cams = _pose_dataset(np.random.default_rng(5), 3 * B + 5)
    ds = TPoseDataset(torch.from_numpy(poses), torch.from_numpy(p2d), cams)
    summary = Summary("unused")
    summary.train_iter_num = 3
    gen_before = {k: v.clone() for k, v in pair.tgen.state_dict().items()}
    rng, mirror = np.random.default_rng(6), np.random.default_rng(6)
    fake = t_sf.run_gan_epoch(pair.t, ds, TPoseTarget(ds.poses_2d), TPoseTarget(ds.poses_3d),
                              B, rng, torch.Generator().manual_seed(1), summary)
    mirror.permutation(len(ds))
    mirror.permutation(len(ds))
    assert rng.bit_generator.state == mirror.bit_generator.state
    assert fake.poses_3d.shape == (3 * B, 16, 3) and fake.cams.shape == (3 * B, 9)
    assert (summary.train_iter_num, summary.train_fakepose_iter_num,
            summary.train_discrim_iter_num) == (6, 1, 3)
    assert set(summary.epoch_scalar_history) == {"3d_wasserstein", "2d_wasserstein", "g_cost"}
    assert any(not torch.equal(v, pair.tgen.state_dict()[k]) for k, v in gen_before.items())
