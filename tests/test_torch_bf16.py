"""``--bf16_trunk`` in the port (models/blocks.py, models/generator.py)
against the JAX package's ``FkGeneratorNet(bf16_trunk=True)`` on the CPU.

The flax semantics: parameters fp32; inputs, weights and biases cast to
bf16; the ReLUs and the residual adds in bf16; the head cast back to fp32.
The head is held to the bound the trunk kernel B3 uses (max 0.03 and mean
2e-3 of the head's std).  One critic phase and one generator update under
SGD, every draw injected, are held to JAX's bf16 deltas: the port's
distance from them must be a tenth or less of the distance between JAX's
own bf16 and fp32 deltas (measured at width 64: critics 5e-7 against 1e-2
(3D) and 6e-14 against 1.4e-6 (2D), generator 3.9e-5 against 1.2e-2).
A ``--bf16_trunk`` CLI run resumes bit for bit."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dhaug_torch import run_fk_gan
from dhaug_torch.gan import video as t_video
from dhaug_torch.gan import wgan as t_wgan
from dhaug_torch.models import convert
from dhaug_torch.models import discriminators as t_disc
from dhaug_torch.models import generator as t_gen
from dhaug_torch.utils.checkpoint import load_snapshot
from dhaug_tpu.gan import video as j_video
from dhaug_tpu.gan import wgan as j_wgan
from dhaug_tpu.models import discriminators as j_disc
from dhaug_tpu.models import generator as j_gen
from dhaug_tpu.train.state import make_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 64
SUBJECTS = ["S1", "S5"]
HEAD_MAX, HEAD_MEAN = 0.03, 2e-3   # of the head's std (B3's bound)
DELTA_RATIO = 0.1                  # port-vs-JAX bf16 over JAX bf16-vs-fp32


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("frames", [1, 3], ids=["single_frame", "video"])
def test_bf16_head_matches_jax(frames):
    cfg_j = j_gen.GeneratorConfig(dense_dim=W, video_frames=frames, bf16_trunk=True)
    net = j_gen.FkGeneratorNet(cfg_j)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((2, 128)))["params"]
    noise = np.random.default_rng(frames).normal(size=(256, 128)).astype(np.float32)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(noise)))
    port = convert.load_generator(
        t_gen.FkGeneratorNet(t_gen.GeneratorConfig(dense_dim=W, video_frames=frames,
                                                   bf16_trunk=True)), _np_tree(params))
    got = port(torch.from_numpy(noise))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    err = np.abs(got.detach().numpy() - want) / want.std()
    assert err.max() <= HEAD_MAX and err.mean() <= HEAD_MEAN, (err.max(), err.mean())
    # the bf16 head is not the fp32 one: the cast pattern is really applied
    fp32 = np.asarray(j_gen.FkGeneratorNet(cfg_j._replace(bf16_trunk=False)).apply(
        {"params": params}, jnp.asarray(noise)))
    assert np.abs(fp32 - want).max() > 10 * np.abs(got.detach().numpy() - want).max()


def _mirror(name, frames=1):
    return {"gen": lambda: t_gen.FkGeneratorNet(t_gen.GeneratorConfig(
                dense_dim=W, video_frames=frames, bf16_trunk=True)),
            "d3d": lambda: t_disc.Fk3DDiscriminator(W),
            "d2d": lambda: t_disc.Fk2DDiscriminator(W)}[name]


_LOAD = {"gen": convert.load_generator, "d3d": convert.load_d3d, "d2d": convert.load_d2d}


def _deltas(name, before, after_tree=None, net=None, frames=1):
    """(after - before) of every tensor of a net, the after side a flax tree
    or a port module."""
    ref = _LOAD[name](_mirror(name, frames)(), _np_tree(before)).state_dict()
    after = (net if net is not None
             else _LOAD[name](_mirror(name, frames)(), _np_tree(after_tree))).state_dict()
    return {k: after[k] - ref[k] for k in ref}


def _assert_bf16_deltas(name, before, j32, j16, port_net, frames=1):
    d32 = _deltas(name, before, after_tree=j32, frames=frames)
    d16 = _deltas(name, before, after_tree=j16, frames=frames)
    t16 = _deltas(name, before, net=port_net, frames=frames)
    gap_jax = max(float((d16[k] - d32[k]).abs().max()) for k in d16)
    gap_port = max(float((t16[k] - d16[k]).abs().max()) for k in d16)
    assert gap_jax > 0, f"{name}: JAX's bf16 and fp32 updates are equal"
    assert gap_port <= DELTA_RATIO * gap_jax, (name, gap_port, gap_jax)


def test_single_frame_critic_phase_and_generator_update_match_jax_bf16():
    from test_torch_gan import _real_poses
    B = 24
    rng = np.random.default_rng(0)
    gens = {bf: j_gen.FkGeneratorNet(j_gen.GeneratorConfig(dense_dim=W, bf16_trunk=bf))
            for bf in (False, True)}
    d3d, d2d = j_disc.Fk3DDiscriminator(dense_dim=W), j_disc.Fk2DDiscriminator(dense_dim=W)
    gp = gens[True].init(jax.random.PRNGKey(0), jnp.zeros((2, 128)))["params"]
    p3 = d3d.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 3)))["params"]
    p2 = d2d.init(jax.random.PRNGKey(2), jnp.zeros((2, 16, 2)))["params"]
    quats, trans, intrs = (np.asarray(x) for x in j_wgan.camera_bank(SUBJECTS))
    real = _real_poses(rng, B)
    cam16 = np.concatenate([np.broadcast_to(intrs[3], (B, 9)), np.broadcast_to(quats[3], (B, 4)),
                            np.broadcast_to(trans[3], (B, 3))], axis=1).astype(np.float32)
    target_2d = (rng.normal(size=(B, 16, 2)) * 0.3).astype(np.float32)
    noise = rng.normal(size=(B, 128)).astype(np.float32)
    scaler8 = (rng.integers(-200, 200, (B, 8)) / 1000.0).astype(np.float32)
    cam_idx = int(rng.integers(0, 4 * len(SUBJECTS)))
    alphas = [rng.uniform(size=(B, 1)).astype(np.float32) for _ in range(4)]
    bone_len = rng.uniform(0.15, 0.6, (B, 15)).astype(np.float32)
    critic_lr, gen_lr = 1e-6, 1e-2   # tests/test_torch_gan.py's step sizes

    jax_after = {}
    for bf in (False, True):
        txs = [optax.sgd(critic_lr), optax.sgd(critic_lr), optax.sgd(gen_lr)]
        steps = j_wgan.make_single_frame_steps(
            lambda p, x, g=gens[bf]: g.apply({"params": p}, x),
            lambda p, x: d3d.apply({"params": p}, x), lambda p, x: d2d.apply({"params": p}, x),
            *txs, j_gen.GeneratorConfig(dense_dim=W, bf16_trunk=bf), j_wgan.GanHyper(),
            *j_wgan.camera_bank(SUBJECTS))
        out = steps.critics_step(
            make_state(txs[0], p3), make_state(txs[1], p2), gp, jnp.asarray(real),
            jnp.asarray(cam16), jnp.asarray(target_2d), jax.random.PRNGKey(9),
            noise=jnp.asarray(noise), scaler8=jnp.asarray(scaler8),
            cam_idx=jnp.asarray(cam_idx, jnp.int32), alphas=tuple(map(jnp.asarray, alphas)))
        gen_s, _ = steps.generator_step(
            make_state(txs[2], gp), p3, p2, jnp.asarray(bone_len),
            jnp.asarray(cam_idx, jnp.int32), jax.random.PRNGKey(3), noise=jnp.asarray(noise),
            scaler8=jnp.asarray(scaler8))
        jax_after[bf] = {"d3d": out[0].params, "d2d": out[1].params, "gen": gen_s.params}

    def port_steps():
        nets = [_LOAD[k](_mirror(k)(), _np_tree(p)) for k, p in
                (("gen", gp), ("d3d", p3), ("d2d", p2))]
        opts = [torch.optim.SGD(n.parameters(), lr=lr)
                for n, lr in zip(nets, (gen_lr, critic_lr, critic_lr))]
        return t_wgan.SingleFrameSteps(*nets, *opts,
                                       t_gen.GeneratorConfig(dense_dim=W, bf16_trunk=True),
                                       t_wgan.GanHyper(), *t_wgan.camera_bank(SUBJECTS))

    critics = port_steps()
    critics.critics_step(torch.from_numpy(real), torch.from_numpy(cam16),
                         torch.from_numpy(target_2d), None, noise=torch.from_numpy(noise),
                         scaler8=torch.from_numpy(scaler8), cam_idx=torch.tensor(cam_idx),
                         alphas=[torch.from_numpy(a) for a in alphas])
    generator = port_steps()
    generator.generator_step(torch.from_numpy(bone_len), torch.tensor(cam_idx), None,
                             noise=torch.from_numpy(noise), scaler8=torch.from_numpy(scaler8))
    for name, before, net in (("d3d", p3, critics.d3d), ("d2d", p2, critics.d2d),
                              ("gen", gp, generator.gen)):
        _assert_bf16_deltas(name, before, jax_after[False][name], jax_after[True][name], net)


def test_video_generator_update_matches_jax_bf16():
    """One video generator update (motion critics on, playback on) with the
    bf16 trunk: a head of F x 35 from one noise vector, the F frames through
    one FK call."""
    B, F = 6, 3
    rng = np.random.default_rng(3)
    cfgs = {bf: j_gen.GeneratorConfig(dense_dim=W, video_frames=F, bf16_trunk=bf)
            for bf in (False, True)}
    nets = (j_disc.Fk3DDiscriminator(dense_dim=W), j_disc.Fk2DDiscriminator(dense_dim=W),
            j_disc.MotionFk3DDiscriminator(video_frames=F, dense_dim=W),
            j_disc.MotionFk2DDiscriminator(video_frames=F, dense_dim=W))
    shapes = ((2, 16, 3), (2, 16, 2), (2, F, 16, 3), (2, F, 16, 2))
    critic_params = [n.init(jax.random.PRNGKey(i + 1), jnp.zeros(s))["params"]
                     for i, (n, s) in enumerate(zip(nets, shapes))]
    gp = j_gen.FkGeneratorNet(cfgs[True]).init(jax.random.PRNGKey(0),
                                               jnp.zeros((2, 128)))["params"]
    noise = rng.normal(size=(B, 128)).astype(np.float32)
    scaler8 = (rng.integers(-200, 200, (B, 8)) / 1000.0).astype(np.float32)
    bone_len = rng.uniform(0.15, 0.6, (B, 15)).astype(np.float32)
    cam_idx = int(rng.integers(0, 4 * len(SUBJECTS)))
    gen_lr = 1e-3   # tests/test_torch_video.py's generator step

    jax_after = {}
    for bf in (False, True):
        gen = j_gen.FkGeneratorNet(cfgs[bf])
        apply = [lambda p, x: gen.apply({"params": p}, x)] + \
            [(lambda n: lambda p, x: n.apply({"params": p}, x))(n) for n in nets]
        txs = [optax.sgd(1e-6) for _ in nets] + [optax.sgd(gen_lr)]
        steps = j_video.make_video_steps(*apply, *txs, cfgs[bf], j_wgan.GanHyper(),
                                         *j_wgan.camera_bank(SUBJECTS), True)
        gen_s, _ = steps.generator_step(
            make_state(txs[-1], gp), *critic_params, jnp.asarray(bone_len),
            jnp.asarray(cam_idx, jnp.int32), jax.random.PRNGKey(5), use_motion=True,
            noise=jnp.asarray(noise), scaler8=jnp.asarray(scaler8))
        jax_after[bf] = gen_s.params

    cfg_t = t_gen.GeneratorConfig(dense_dim=W, video_frames=F, bf16_trunk=True)
    port = [convert.load_generator(t_gen.FkGeneratorNet(cfg_t), _np_tree(gp))] + [
        load(make(), _np_tree(p)) for load, make, p in zip(
            (convert.load_d3d, convert.load_d2d, convert.load_md3d, convert.load_md2d),
            (lambda: t_disc.Fk3DDiscriminator(W), lambda: t_disc.Fk2DDiscriminator(W),
             lambda: t_disc.MotionFk3DDiscriminator(F, W),
             lambda: t_disc.MotionFk2DDiscriminator(F, W)), critic_params)]
    opts = [torch.optim.SGD(port[0].parameters(), lr=gen_lr)] + \
        [torch.optim.SGD(n.parameters(), lr=1e-6) for n in port[1:]]
    steps = t_video.VideoSteps(*port, *opts, cfg_t, t_wgan.GanHyper(),
                               *t_wgan.camera_bank(SUBJECTS), playback=True)
    steps.generator_step(torch.from_numpy(bone_len), torch.tensor(cam_idx), None, True,
                         noise=torch.from_numpy(noise), scaler8=torch.from_numpy(scaler8))
    _assert_bf16_deltas("gen", gp, jax_after[False], jax_after[True], port[0], frames=F)


# the TINY widths of tests/test_torch_checkpoint.py, 3 epochs of 4 GAN
# iterations (1200 frames in batches of 256), a snapshot every 2, with
# --bf16_trunk
RUN = ["--posenet_name", "mlp", "--lr_p", "1e-3", "--keypoints", "gt",
       "--batch_size", "256", "--downsample", "4", "--data_enhancement_method", "GAN",
       "--single_or_multi_train_mode", "single", "--epochs", "3", "--snapshot", "2",
       "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
       "--Gen_DenseDim", "32", "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32",
       "--bf16_trunk", "true", "--data_root", REPO, "--device", "cpu"]


def test_bf16_trunk_run_resumes_bit_for_bit(tmp_path):
    """Stopped after epoch 1 and resumed, a --bf16_trunk run ends where the
    uninterrupted one does: scores, scalars, and every parameter and
    optimizer state (all fp32) under torch.equal."""
    a = run_fk_gan.main(RUN + ["--checkpoint", str(tmp_path / "a")])
    assert a["gan"].gen.dtype == torch.bfloat16
    snapshot = os.path.join(a["run_dir"], "ckpt_resume_latest.ckpt")
    saved = load_snapshot(snapshot)
    assert saved["epoch"] == 1
    assert all(v.dtype == torch.float32 for v in saved["gen_state"]["model"].values())
    b = run_fk_gan.main(RUN + ["--checkpoint", str(tmp_path / "b"), "--resume", snapshot])
    assert len(b["epoch_seconds"]) == 1
    assert b["scores"] == a["scores"] and b["epoch_scalars"] == a["epoch_scalars"]
    for name in ("gen", "d3d", "d2d"):
        net_a, net_b = getattr(a["gan"], name), getattr(b["gan"], name)
        for k, v in net_a.state_dict().items():
            assert torch.equal(v, net_b.state_dict()[k]), (name, k)
        sa = getattr(a["gan"], f"{name}_opt").state_dict()["state"]
        sb = getattr(b["gan"], f"{name}_opt").state_dict()["state"]
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i]), name
    for k, v in a["posenet"].state_dict().items():
        assert torch.equal(v, b["posenet"].state_dict()[k]), k
