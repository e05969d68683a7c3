"""dhaug_torch models with weights copied from the flax models
(models/convert.py): forward parity <= 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch.models import convert
from dhaug_torch.models import discriminators as t_disc
from dhaug_torch.models import generator as t_gen
from dhaug_torch.models import posenets as t_pose
from dhaug_tpu.models import discriminators as j_disc
from dhaug_tpu.models import generator as j_gen
from dhaug_tpu.models import posenets as j_pose

TOL = 1e-5
WIDTH = 48


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol)


def test_generator_trunk_and_pose_synthesis():
    rng = np.random.default_rng(0)
    net = j_gen.FkGeneratorNet(j_gen.GeneratorConfig(dense_dim=WIDTH))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((2, 128)))["params"]
    port = convert.load_generator(
        t_gen.FkGeneratorNet(t_gen.GeneratorConfig(dense_dim=WIDTH)), _np_tree(params))

    noise = rng.normal(size=(40, 128)).astype(np.float32)
    head_j = net.apply({"params": params}, jnp.asarray(noise))
    head_t = port(torch.from_numpy(noise))
    _close(head_t, head_j)

    bl = rng.uniform(0.1, 0.6, (40, 15)).astype(np.float32)
    scaler = (rng.integers(-200, 200, (40, 8)) / 1000.0).astype(np.float32)
    pose_j = j_gen.synthesize_poses(head_j, jnp.asarray(bl), jnp.asarray(scaler),
                                    j_gen.GeneratorConfig(dense_dim=WIDTH))
    pose_t = t_gen.synthesize_poses(head_t, torch.from_numpy(bl), torch.from_numpy(scaler),
                                    t_gen.GeneratorConfig(dense_dim=WIDTH))
    assert pose_t.shape == (40, 16, 3)
    _close(pose_t, pose_j)


@pytest.mark.parametrize("use_pre_angle,use_global_rot", [(True, True), (False, False)])
def test_head_to_angles(use_pre_angle, use_global_rot):
    head = np.random.default_rng(1).normal(size=(12, 35)).astype(np.float32) * 2
    cfg_kw = dict(use_pre_angle=use_pre_angle, use_global_rot=use_global_rot)
    a_j, r_j = j_gen.head_to_angles(jnp.asarray(head), j_gen.GeneratorConfig(**cfg_kw))
    a_t, r_t = t_gen.head_to_angles(torch.from_numpy(head), t_gen.GeneratorConfig(**cfg_kw))
    _close(a_t, a_j, tol=2e-5)
    _close(r_t, r_j)
    # column 31 of the head is unused
    head2 = head.copy()
    head2[:, 31] += 5.0
    a_t2, _ = t_gen.head_to_angles(torch.from_numpy(head2), t_gen.GeneratorConfig(**cfg_kw))
    torch.testing.assert_close(a_t2, a_t, atol=0, rtol=0)


def test_critics():
    rng = np.random.default_rng(2)
    d3d = j_disc.Fk3DDiscriminator(dense_dim=WIDTH)
    d2d = j_disc.Fk2DDiscriminator(dense_dim=WIDTH)
    p3 = d3d.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 3)))["params"]
    p2 = d2d.init(jax.random.PRNGKey(2), jnp.zeros((2, 16, 2)))["params"]
    t3 = convert.load_d3d(t_disc.Fk3DDiscriminator(WIDTH), _np_tree(p3))
    t2 = convert.load_d2d(t_disc.Fk2DDiscriminator(WIDTH), _np_tree(p2))
    x3 = (rng.normal(size=(50, 16, 3)) * 0.3).astype(np.float32)
    x2 = (rng.normal(size=(50, 16, 2)) * 0.3).astype(np.float32)
    _close(t3(torch.from_numpy(x3)), d3d.apply({"params": p3}, jnp.asarray(x3)))
    _close(t2(torch.from_numpy(x2)), d2d.apply({"params": p2}, jnp.asarray(x2)))


def test_convert_rejects_mismatched_trees():
    d2d = j_disc.Fk2DDiscriminator(dense_dim=WIDTH)
    p2 = _np_tree(d2d.init(jax.random.PRNGKey(2), jnp.zeros((2, 16, 2)))["params"])
    with pytest.raises(ValueError, match="shape"):
        convert.load_d2d(t_disc.Fk2DDiscriminator(WIDTH + 1), p2)
    del p2["Dense_5"]
    with pytest.raises(ValueError, match="expected"):
        convert.load_d2d(t_disc.Fk2DDiscriminator(WIDTH), p2)


def _linear_models(stages=2, width=64):
    model = j_pose.LinearModel(linear_size=width, num_stage=stages, dropout=0.0)
    variables = model.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                           jnp.zeros((2, 16, 2)), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    # non-trivial BN affine params and running stats, so eval mode tests them
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda x: x + rng.normal(size=x.shape).astype(np.float32) * 0.1,
                          params)
    stats = jax.tree.map(lambda x: np.abs(x + rng.normal(size=x.shape).astype(np.float32)
                                          * 0.1), stats)
    port = t_pose.LinearModel(linear_size=width, num_stage=stages, p_dropout=0.0)
    convert.load_linear_model(port, _np_tree(params), _np_tree(stats))
    return model, params, stats, port


def test_linear_model_eval_mode():
    model, params, stats, port = _linear_models()
    x = np.random.default_rng(6).normal(size=(33, 16, 2)).astype(np.float32)
    ref = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == (33, 16, 3)
    assert float(out[:, 0].abs().max()) == 0.0  # hip padded with zeros
    _close(out, ref)


def test_linear_model_train_mode_and_running_stats():
    model, params, stats, port = _linear_models()
    x = np.random.default_rng(7).normal(size=(48, 16, 2)).astype(np.float32)
    ref, mutated = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                               mutable=["batch_stats"])
    port.train()
    _close(port(torch.from_numpy(x)), ref)
    new = _np_tree(mutated["batch_stats"])
    _close(port.bn_in.running_mean, new["BatchNorm_0"]["mean"], tol=1e-6)
    _close(port.bn_in.running_var, new["BatchNorm_0"]["var"], tol=1e-6)
    for i, stage in enumerate(port.stages):
        s = new[f"_LinearStage_{i}"]
        _close(stage.bn1.running_mean, s["BatchNorm_0"]["mean"], tol=1e-6)
        _close(stage.bn1.running_var, s["BatchNorm_0"]["var"], tol=1e-6)
        _close(stage.bn2.running_mean, s["BatchNorm_1"]["mean"], tol=1e-6)
        _close(stage.bn2.running_var, s["BatchNorm_1"]["var"], tol=1e-6)


def test_he_normal_matches_flax_distribution():
    from dhaug_torch.models.blocks import dense
    torch.manual_seed(0)
    w = dense(400, 2000).weight.detach().numpy().ravel()
    flax_w = np.asarray(jax.nn.initializers.he_normal()(jax.random.PRNGKey(0), (400, 2000)))
    std = np.sqrt(2.0 / 400)
    assert abs(w.std() - flax_w.std()) < 0.01 * std
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
