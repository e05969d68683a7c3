"""Tensor parallelism in the port (dhaug_torch/parallel/tensor.py on the
(data, model) rank grid of dhaug_torch/parallel/mesh.py) on the CPU: gloo
ranks, each a spawned process with one thread, against one process and
against the JAX package's (1, 2) mesh.

The ranks run tests/test_torch_dp_worker.py's functions through
tests/test_torch_tp_worker.py, which shards every net's layers of output
width >= 16 (the JAX tests' ``min_width`` for their width-32 nets) and
returns the weights in the single-device layout.  Bounds:

* one critic phase and one generator update with SGD and injected draws on
  a (1, 2) grid: the updated weights within 1e-6 (critics) and 1e-5
  (generator) of one process, fakes 1e-6, scalars 1e-6 relative, as
  tests/test_torch_parallel.py holds two data ranks; against the JAX
  package's steps on ``make_mesh(2, model_axis=2)`` with
  ``place_state(min_width=16)``, its cross-package bounds (weights 1e-6 /
  1e-5, scalars rtol 1e-4; fakes 5e-5, as the test says why);
* the gradient penalty's parameter gradients (a second differentiation
  through the column-parallel layers' backward): 1e-5 of each leaf's
  largest element, the penalty 1e-6 relative;
* a (2, 2) GAN epoch with Adam: the JAX package's sharded-vs-single bounds
  (tests/test_parallel.py:232-243), through
  ``test_torch_parallel.check_gan_epoch``;
* a posenet epoch with batch norm and dropout and evaluation: the bounds of
  tests/test_torch_parallel.py's posenet tests;
* the clipped global norm: 1e-6 relative; snapshots: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dp_worker as dpw
import test_torch_tp_worker as worker
from dhaug_torch.parallel import mesh
from test_torch_gan import (CRITIC_LR, GEN_LR, SUBJECTS, W, Pair, _assert_delta, _batch, _draws,
                            _jax_draws)
from test_torch_parallel import (_close, _frames, _one_intra_op_thread, _sds,  # noqa: F401
                                 _sequences, check_gan_epoch)


def on_grid(target, *args, data=1, model=2):
    """``tests/test_torch_tp_worker.<target>(*args)`` on a (data, model)
    grid of gloo ranks; every rank's result, in global rank order."""
    return mesh.launch(f"test_torch_tp_worker:{target}", args, ["cpu"] * (data * model),
                       "gloo", threads=1, model_parallel=model)


# ---------------------------------------------------------------------------
# one critic phase and one generator update
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps_case():
    critics, gens = Pair(lr=CRITIC_LR), Pair(lr=GEN_LR)
    rng = np.random.default_rng(0)
    batch = _batch(rng, critics)
    draws = _draws(rng)
    gen_draws = _draws(rng)
    gen_inputs = dict(bone_len=rng.uniform(0.15, 0.6, (len(batch[0]), 15)).astype(np.float32),
                      cam_idx=gen_draws["cam_idx"], noise=gen_draws["noise"],
                      scaler8=gen_draws["scaler8"])
    args = (W, SUBJECTS, _sds(critics.tgen, critics.td3d, critics.td2d), CRITIC_LR,
            _sds(gens.tgen, gens.td3d, gens.td2d), GEN_LR, batch, draws, gen_inputs)
    one = dpw.gan_step_phases(*args)
    ranks = on_grid("run", "gan_step_phases", *args)
    return critics, gens, batch, draws, gen_inputs, one, ranks


def test_tp2_steps_equal_one_process(steps_case):
    *_, one, ranks = steps_case
    assert [r["model_rank"] for r in ranks] == [0, 1]
    for r in ranks:
        for net, tol in (("d3d", 1e-6), ("d2d", 1e-6), ("gen", 1e-5)):
            for k, v in one[net].items():
                _close(r[net][k], v, tol, what=f"{net}.{k}")
        for k in ("bone_len", "fake3d", "fake2d", "intr", "fk_rows"):
            _close(r[k], one[k], 1e-6, what=k)
        for k, v in one["metrics"].items():
            _close(r["metrics"][k], v, 1e-6, 1e-6, what=k)
        _close(r["g_cost"], one["g_cost"], 1e-6, 1e-6, what="g_cost")
        assert r["cam_idx"] == one["cam_idx"]
    for net in ("d3d", "d2d", "gen"):
        assert all(np.array_equal(ranks[0][net][k], ranks[1][net][k]) for k in one[net])


def test_tp2_steps_equal_the_jax_package_on_a_1x2_mesh(steps_case):
    """The JAX steps on ``make_mesh(2, model_axis=2)``, every state placed
    by ``place_state(min_width=16)`` (tests/test_parallel.py:189-243)."""
    from jax.sharding import PartitionSpec as P

    from dhaug_torch.models import convert
    from dhaug_torch.models import discriminators as t_disc
    from dhaug_torch.models import generator as t_gen
    from dhaug_tpu.parallel.mesh import make_mesh, place_state, shard_batch

    critics, gens, batch, draws, gen_inputs, _, ranks = steps_case
    m = make_mesh(2, model_axis=2)
    place = lambda s: place_state(m, s, min_width=16)
    with m:
        d3d_in = place(critics.d3d_s)
        assert any(x.sharding.spec == P(None, "model") for x in jax.tree.leaves(d3d_in.params)
                   if x.ndim == 2)
        real, cam16, tgt2d = shard_batch(m, *(jnp.asarray(x) for x in batch))
        d3d_s, d2d_s, _, _, f3d, f2d, _, m_j = critics.j.critics_step(
            d3d_in, place(critics.d2d_s), place(critics.gen_s.params), real, cam16, tgt2d,
            jax.random.PRNGKey(9), **_jax_draws(draws))
        gen_s, gm = gens.j.generator_step(
            place(gens.gen_s), place(gens.p3), place(gens.p2),
            shard_batch(m, jnp.asarray(gen_inputs["bone_len"])),
            jnp.asarray(gen_inputs["cam_idx"], jnp.int32), jax.random.PRNGKey(3),
            noise=jnp.asarray(gen_inputs["noise"]), scaler8=jnp.asarray(gen_inputs["scaler8"]))
    r = ranks[0]
    load = dpw.load_state
    _assert_delta(convert.load_d3d, load(t_disc.Fk3DDiscriminator(W), r["d3d"]), critics.p3,
                  d3d_s.params, 1e-6, "d3d")
    _assert_delta(convert.load_d2d, load(t_disc.Fk2DDiscriminator(W), r["d2d"]), critics.p2,
                  d2d_s.params, 1e-6, "d2d")
    _assert_delta(convert.load_generator,
                  load(t_gen.FkGeneratorNet(t_gen.GeneratorConfig(dense_dim=W)), r["gen"]),
                  gens.gp, gen_s.params, 1e-5, "generator")
    # the fakes reach ~11 m; the JAX package's own (1, 2) mesh moves them
    # 3.8e-5 m (3D) and 1.8e-5 (2D) from its single-device run (XLA cuts
    # the generator's products by columns; measured), where the port's tp2
    # stays within 1e-6 of its one process: held to 5e-5
    _close(r["fake3d"], np.asarray(f3d), 5e-5, what="fake3d")
    _close(r["fake2d"], np.asarray(f2d), 5e-5, what="fake2d")
    for k, v in m_j.items():
        _close(r["metrics"][k], float(v), 1e-5, 1e-4, what=k)
    _close(r["g_cost"], float(gm["g_cost"]), 1e-6, 1e-5, what="g_cost")


def test_tp2_video_steps_equal_one_process():
    """The video steps (motion critics and playback on) at the bounds of
    tests/test_torch_parallel.py's video step test."""
    from test_torch_video import CRITIC_2D_LR, CRITIC_3D_LR, F, VideoPair
    from test_torch_video import GEN_LR as VIDEO_GEN_LR
    from test_torch_video import _draws as video_draws
    pair = VideoPair(playback=True)
    rng = np.random.default_rng(11)
    batch = pair.batch(rng, cam_row=2)
    draws, gen_draws = video_draws(rng), video_draws(rng)
    lrs = (VIDEO_GEN_LR, CRITIC_3D_LR, CRITIC_2D_LR, CRITIC_3D_LR, CRITIC_2D_LR)
    args = (W, F, SUBJECTS, _sds(*pair.t_nets), lrs, batch, draws,
            {k: gen_draws[k] for k in ("noise", "scaler8")})
    one = dpw.video_step_phases(*args)
    for r in on_grid("run", "video_step_phases", *args):
        for got, want in zip(r["critics"], one["critics"]):
            for k, v in want.items():
                _close(got[k], v, 1e-6, what=k)
        for k, v in one["gen"].items():
            _close(r["gen"][k], v, 1e-5, what=k)
        for k in ("fake3d", "fake2d"):
            _close(r[k], one[k], 5e-5, what=k)
        for k, v in one["metrics"].items():
            _close(r["metrics"][k], v, 1e-4 * max(abs(v), 1.0), what=k)
        _close(r["g_cost"], one["g_cost"], 1e-4 * max(abs(one["g_cost"]), 1.0), what="g_cost")


# ---------------------------------------------------------------------------
# the gradient penalty's double backward
# ---------------------------------------------------------------------------

CRITICS = ["d3d", "d2d", "md3d", "md2d"]


@pytest.fixture(scope="module")
def penalty_case():
    """Fresh critics at width 32 (clips of 3 frames for the motion ones),
    8 real and fake samples each, one alpha a sample, lambda 10."""
    from test_torch_gan import _real_poses
    from test_torch_video import _clips
    rng = np.random.default_rng(12)
    n, frames = 8, 3
    f32 = lambda a: np.asarray(a, np.float32)
    reals = [_real_poses(rng, n) * 0.2, f32(rng.normal(size=(n, 16, 2)) * 0.3),
             _clips(rng, n, frames=frames) * 0.2, f32(rng.normal(size=(n, frames, 16, 2)) * 0.3)]
    fakes = [f32(rng.normal(size=r.shape) * 0.3) for r in reals]
    alphas = [f32(rng.uniform(size=(n,) + (1,) * (r.ndim - 1))) for r in reals]
    torch.manual_seed(0)
    sds = [dpw._state(c) for c in worker.critic_nets(W, frames)]   # seeded, whole here
    args = (W, frames, sds, reals, fakes, alphas, 10.0)
    return worker.gradient_penalty_grads(*args), on_grid("gradient_penalty_grads", *args)


@pytest.mark.parametrize("critic", CRITICS)
def test_gradient_penalty_parameter_gradients_on_tp2(penalty_case, critic):
    one, ranks = penalty_case
    i = CRITICS.index(critic)
    for r in ranks:
        _close(r["gp"][i], one["gp"][i], 0.0, 1e-6, what="gp")
        for k, want in one["grads"][i].items():
            # the input gradient of a piecewise-linear net does not move
            # with its biases: their gradients are 0 in both runs
            scale = float(np.abs(want).max())
            assert scale > 0 or k.endswith("bias"), k
            _close(r["grads"][i][k], want, 1e-5 * scale, what=f"{critic}.{k}")


# ---------------------------------------------------------------------------
# whole GAN epochs on a (2, 2) grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["single", "video"])
def test_a_gan_epoch_on_a_2x2_grid_equals_one_process(mode):
    """tests/test_torch_parallel.py's GAN epoch (six batches, Adam, the
    generator at iteration 4) on four ranks: two data indices, each a model
    group of two.  Held by ``check_gan_epoch``: weights rtol 1e-3 / atol
    5e-4, the Wasserstein trajectory and fakes 1e-4, every rank's gathered
    weights bit-identical (video mode sets apart the elements whose
    gradient is zero to rounding, as that test states)."""
    if mode == "single":
        args = ("single", W, 1, SUBJECTS, _frames(100, 3), 16, 5)
    else:
        args = ("video", W, 3, SUBJECTS, _sequences(4, n=8), 8, 5)
    one = dpw.gan_epoch(*args)
    ranks = on_grid("run", "gan_epoch", *args, data=2)
    assert [r["model_rank"] for r in ranks] == [0, 1, 0, 1]
    check_gan_epoch(mode, one, ranks)


# ---------------------------------------------------------------------------
# posenets, evaluation and the global norm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def posenet_case():
    """tests/test_torch_parallel.py's posenet case: the MLP (64 wide) and
    the multi-frame VideoPose (32 channels) on tp2."""
    rng = np.random.default_rng(6)
    frames = lambda n, d: (rng.normal(size=(n, 16, d)) * 0.3).astype(np.float32)
    train_set = (frames(80, 2), frames(80, 3), frames(8, 2))
    eval_set = (frames(101, 2), frames(101, 3))
    lengths = (40, 29, 33)
    windows = ([frames(m, 3) for m in lengths], [frames(m, 2) for m in lengths])
    args = (train_set, eval_set, windows, 16, 7, (16, 12, 7))
    return dpw.posenet_epochs(*args), on_grid("run", "posenet_epochs", *args)


def test_a_posenet_epoch_with_batch_norm_and_dropout_on_tp2(posenet_case):
    one, ranks = posenet_case
    for net in ("mlp", "video"):
        assert all(np.array_equal(ranks[0][net][k], ranks[1][net][k]) for k in one[net])
    for r in ranks:
        for k, v in one["bn_first_batch"].items():
            _close(r["bn_first_batch"][k], v, 1e-6, what=k)
        for k in ("mlp_loss", "video_loss"):
            _close(r[k], one[k], 0.0, 1e-4, what=k)
        for k in ("mlp_pred", "video_pred"):
            _close(r[k], one[k], 5e-3, what=k)


def test_evaluation_on_tp2_equals_one_process(posenet_case):
    one, ranks = posenet_case
    cases = [(one["mlp_eval"][k], ranks[0]["mlp_eval"][k]) for k in one["mlp_eval"]]
    cases.append((one["video_eval"], ranks[0]["video_eval"]))
    for want, got in cases:
        for k in ("p1", "p2", "pck", "auc"):
            _close(got[k], want[k], 1e-4, what=k)
    assert ranks[0]["mlp_eval"] == ranks[1]["mlp_eval"]


@pytest.mark.parametrize("max_norm", [1e-3, 1e9])
def test_clipped_global_norm_of_a_sharded_module_is_the_whole_ones(max_norm):
    """``clip_by_global_norm`` on the MLP on tp2: the norm of the
    single-device gradients, and the same clipped gradients (clipping on,
    and off)."""
    rng = np.random.default_rng(13)
    x = (rng.normal(size=(16, 16, 2)) * 0.3).astype(np.float32)
    y = (rng.normal(size=(16, 16, 3)) * 0.3).astype(np.float32)
    one = worker.clipped_norm(64, x, y, max_norm)
    assert (one["norm"] > max_norm) == (max_norm < 1)
    # 1e-6 of the largest gradient element: a bias before batch norm has a
    # gradient of 0 up to rounding, which no relative bound can hold
    scale = max(float(np.abs(v).max()) for v in one["grads"].values())
    for r in on_grid("clipped_norm", 64, x, y, max_norm):
        _close(r["norm"], one["norm"], 0.0, 1e-6, what="norm")
        for k, v in one["grads"].items():
            _close(r["grads"][k], v, 1e-6 * scale, what=k)


def test_each_rank_holds_one_block_of_every_wide_layer():
    """On tp2 every layer at least 16 wide whose width divides by 2 holds
    half its weight and bias, and so do their Adam moments; the others
    stay whole (the GAN head's 35 outputs, the MLP's 45, PoseFormer's
    4-wide spatial blocks)."""
    ranks = on_grid("block_sizes", 64)
    for name in ranks[0]:
        blocks = 0
        for k, leaf in ranks[0][name].items():
            for r in ranks:
                assert r[name][k] == leaf
            if leaf["sharded"]:
                blocks += 1
                assert leaf["param"] * 2 == leaf["whole"], (name, k)
            else:
                assert leaf["param"] == leaf["whole"], (name, k)
            assert leaf["moments"] == [leaf["param"]] * 2, (name, k)
        assert blocks >= 2, name
    assert not ranks[0]["gen"]["head.weight"]["sharded"]
    assert ranks[0]["gen"]["prelude.fc.weight"]["sharded"]
    assert ranks[0]["videopose"]["expand_conv.weight"]["sharded"]
    assert ranks[0]["poseformer"]["blocks.0.attn.qkv.weight"]["sharded"]
    assert not ranks[0]["poseformer"]["Spatial_blocks.0.attn.qkv.weight"]["sharded"]


def test_the_bf16_trunk_keeps_its_collectives_on_tp2():
    """``--bf16_trunk``'s generator computes each wide layer in bf16
    through the column-parallel layer (not on one rank's block alone): its
    head and gradients on tp2 equal one process's to bf16's rounding."""
    noise = np.random.default_rng(14).normal(size=(8, 128)).astype(np.float32)
    one = worker.bf16_generator(W, noise)
    for r in on_grid("bf16_generator", W, noise):
        _close(r["head"], one["head"], 2e-2 * float(np.abs(one["head"]).max()), what="head")
        for k, v in one["grads"].items():
            _close(r["grads"][k], v, 2e-2 * float(np.abs(v).max()), what=k)


def test_a_model_axis_that_divides_no_wide_layer_fails_loudly(monkeypatch):
    """``--model_parallel_devices 3`` against the 1000-wide GAN nets shards
    nothing and stops with the JAX package's words; 2 shards them."""
    from dhaug_torch.models import discriminators, generator
    from dhaug_torch.parallel.tensor import assert_model_sharded, shard_module_tp

    def nets():
        return [generator.FkGeneratorNet(generator.GeneratorConfig()),
                discriminators.Fk3DDiscriminator(), discriminators.Fk2DDiscriminator()]

    monkeypatch.setattr(mesh, "_CURRENT", mesh.DataParallel(model=mesh.ModelAxis(0, 3)))
    three = nets()
    assert sum(shard_module_tp(n) for n in three) == 0
    with pytest.raises(SystemExit, match="--model_parallel_devices 3 sharded no layer of the "
                                         "GAN net states"):
        assert_model_sharded(*three)
    monkeypatch.setattr(mesh, "_CURRENT", mesh.DataParallel(model=mesh.ModelAxis(1, 2)))
    two = nets()
    assert [shard_module_tp(n) for n in two] == [7, 14, 5]
    assert_model_sharded(*two)
    assert two[0].prelude.fc.weight.shape == (500, 128)
