"""dhaug_torch posenet training and evaluation against dhaug_tpu (CPU)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dhaug_torch.models import convert
from dhaug_torch.models import posenets as t_pose
from dhaug_torch.ops.augment import flip_pose
from dhaug_torch.train import posenet as t_train
from dhaug_torch.train import state as t_state
from dhaug_tpu.models import posenets as j_pose
from dhaug_tpu.ops.augment import flip_pose as j_flip_pose
from dhaug_tpu.train import posenet as j_train
from dhaug_tpu.train import state as j_state
from dhaug_tpu.train.state import make_state

WIDTH, STAGES, B = 64, 2, 48


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models():
    model = j_pose.LinearModel(linear_size=WIDTH, num_stage=STAGES, dropout=0.0)
    v = model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                   jnp.zeros((2, 16, 2)), train=False)
    port = t_pose.LinearModel(linear_size=WIDTH, num_stage=STAGES, p_dropout=0.0)
    convert.load_linear_model(port, _np_tree(v["params"]), _np_tree(v["batch_stats"]))
    return model, v["params"], v["batch_stats"], port


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 16, 2)) * 0.4).astype(np.float32)
    y = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    return x, y


def test_train_step_with_flip_duplicate_sgd_parity():
    """MSE step + the flipped second step, global-norm clip at 1.0 (engaged
    here), SGD on both sides: params and BatchNorm running stats <= 1e-6."""
    model, params, stats, port = _models()
    lr = 0.05
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(lr))
    step = j_train.make_posenet_train_step(model, tx)
    state = make_state(tx, params, stats)
    opt = torch.optim.SGD(port.parameters(), lr=lr)
    x, y = _data(0, B)
    y_rel = y - y[:, :1]
    for xs, ys in ((x, y_rel), (None, None)):
        if xs is None:  # the flip duplicate
            xs_j, ys_j = j_flip_pose(jnp.asarray(x)), j_flip_pose(jnp.asarray(y_rel))
            xs_t, ys_t = flip_pose(torch.from_numpy(x)), flip_pose(torch.from_numpy(y_rel))
        else:
            xs_j, ys_j, xs_t, ys_t = (jnp.asarray(xs), jnp.asarray(ys),
                                      torch.from_numpy(xs), torch.from_numpy(ys))
        state, loss_j = step(state, xs_j, ys_j, jax.random.PRNGKey(2))
        port.train()
        loss_t = torch.mean((port(xs_t) - ys_t) ** 2)
        opt.zero_grad()
        loss_t.backward()
        norm = t_state.clip_by_global_norm(port.parameters(), 1.0)
        opt.step()
        assert float(norm) > 1.0  # the clip is engaged
        np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-6)

    ref = t_pose.LinearModel(linear_size=WIDTH, num_stage=STAGES, p_dropout=0.0)
    convert.load_linear_model(ref, _np_tree(state.params), _np_tree(state.batch_stats))
    ref_sd = ref.state_dict()
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=1e-6, err_msg=k)


def test_train_epoch_draws_one_permutation_and_moves_the_model():
    _, _, _, port = _models()
    x, y = _data(1, 2 * B + 7)
    opt = t_state.adam_posenet(port.parameters(), 1e-3)
    before = [p.detach().clone() for p in port.parameters()]
    rng, mirror = np.random.default_rng(3), np.random.default_rng(3)
    loss = t_train.train_epoch(port, opt, x, y, rng, B, max_norm=1.0)
    mirror.permutation(x.shape[0])
    assert rng.bit_generator.state == mirror.bit_generator.state
    assert np.isfinite(loss)
    assert any(not torch.equal(a, b) for a, b in zip(before, port.parameters()))


def test_evaluation_matches_the_scan_evaluator():
    """H36M-style (no flip) and 3DHP-style (flip-averaged) evaluation with
    exact per-frame weighting over a set that is not a multiple of the
    batch: P1/P2 within 1e-3 mm, PCK/AUC within 1e-3 %."""
    model, params, stats, port = _models()
    rng = np.random.default_rng(4)
    stats = jax.tree.map(lambda s: np.abs(np.asarray(s) + rng.normal(size=s.shape) * 0.1)
                         .astype(np.float32), stats)
    convert.load_linear_model(port, _np_tree(params), _np_tree(stats))
    x, y = _data(5, 150)
    for flip in (False, True):
        fn = j_train.make_eval_epoch_fn(model, flip=flip)
        ref = j_train.evaluate_scan(fn, params, stats, jnp.asarray(x), jnp.asarray(y), 64)
        got = t_train.evaluate(port, x, y, 64, flip=flip)
        for k in ("p1", "p2", "pck", "auc"):
            np.testing.assert_allclose(got[k], ref[k], atol=1e-3, rtol=0, err_msg=(flip, k))


def test_lambda_lr_and_set_learning_rate():
    for epoch in range(0, 12):
        assert t_state.lambda_lr(1e-3, epoch, 10) == j_state.lambda_lr(1e-3, epoch, 10)
    _, _, _, port = _models()
    opt = t_state.adam_posenet(port.parameters(), 1e-3)
    t_state.set_learning_rate(opt, 2.5e-4)
    assert all(g["lr"] == 2.5e-4 for g in opt.param_groups)


def test_clip_by_global_norm_leaves_small_gradients_alone():
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([0.3, 0.4, 0.0])
    t_state.clip_by_global_norm([p], 1.0)
    torch.testing.assert_close(p.grad, torch.tensor([0.3, 0.4, 0.0]), atol=0, rtol=0)
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    t_state.clip_by_global_norm([p], 1.0)
    torch.testing.assert_close(p.grad, torch.tensor([0.6, 0.8, 0.0]))


def _other_posenets(name):
    """Small flax and port nets of the other four kinds, dropout and
    drop-path 0 (the sizes of tests/test_torch_posenets.py)."""
    if name == "gcn":
        from dhaug_torch.data.h36m import Human36mDataset
        from dhaug_torch.models.factory import adjacency_from_skeleton
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        skeleton = Human36mDataset(os.path.join(repo, "data", "data_3d_h36m.npz")).skeleton()
        adj = adjacency_from_skeleton(skeleton)
        return (j_pose.SemGCN(adj=adj, hid_dim=24, num_layers=2, dropout=0.0),
                lambda: t_pose.SemGCN(adj, hid_dim=24, num_layers=2, p_dropout=0.0), 1)
    if name == "videopose":
        kw = dict(out_joints=15, pad_hip_joint=True, channels=40, strided=True)
        return (j_pose.TemporalPoseNet(filter_widths=(1, 1, 1), dropout=0.0, **kw),
                lambda: t_pose.TemporalPoseNet((1, 1, 1), p_dropout=0.0, **kw), 1)
    if name == "mulit_farme_videopose":
        kw = dict(out_joints=16, channels=40, strided=True)
        return (j_pose.TemporalPoseNet(filter_widths=(3, 3), dropout=0.0, **kw),
                lambda: t_pose.TemporalPoseNet((3, 3), p_dropout=0.0, **kw), 9)
    kw = dict(num_frame=9, embed_dim_ratio=16, depth=2, num_heads=4, drop_path_rate=0.0)
    return j_pose.PoseFormer(**kw), lambda: t_pose.PoseFormer(**kw), 9


@pytest.mark.parametrize("name", ["gcn", "videopose", "mulit_farme_videopose",
                                  "mulit_farme_poseformer"])
def test_other_posenets_clipped_sgd_step_parity(name):
    """The MSE step and its flipped duplicate, global-norm clip at 1.0
    and SGD on both sides, for the posenets other than the MLP:
    params and BatchNorm running stats <= 1e-6."""
    jm, make_port, frames = _other_posenets(name)
    rng = np.random.default_rng(7)
    shape = (B, 16, 2) if frames == 1 else (B, frames, 16, 2)
    x = (rng.normal(size=shape) * 0.4).astype(np.float32)
    y = (rng.normal(size=(B, 16, 3) if frames == 1 else (B, 1, 16, 3)) * 0.3).astype(np.float32)
    y_rel = y - y[..., :1, :]
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                jnp.asarray(x[:2]), train=False)
    params, stats = v["params"], v.get("batch_stats", {})
    port = make_port()
    convert.load_posenet(name, port, _np_tree(params), _np_tree(stats))
    lr = 0.05
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(lr))
    step = j_train.make_posenet_train_step(jm, tx)
    state = make_state(tx, params, stats)
    opt = torch.optim.SGD(port.parameters(), lr=lr)
    for xs, ys in ((x, y_rel), (None, None)):
        if xs is None:  # the flip duplicate
            xs_j, ys_j = j_flip_pose(jnp.asarray(x)), j_flip_pose(jnp.asarray(y_rel))
            xs_t, ys_t = flip_pose(torch.from_numpy(x)), flip_pose(torch.from_numpy(y_rel))
        else:
            xs_j, ys_j, xs_t, ys_t = (jnp.asarray(xs), jnp.asarray(ys),
                                      torch.from_numpy(xs), torch.from_numpy(ys))
        state, loss_j = step(state, xs_j, ys_j, jax.random.PRNGKey(2))
        loss_t = t_train.train_step(port, opt, xs_t, ys_t, max_norm=1.0)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    ref = make_port()
    convert.load_posenet(name, ref, _np_tree(state.params), _np_tree(state.batch_stats))
    ref_sd = ref.state_dict()
    for k, v in port.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(), atol=1e-6, err_msg=k)
    before = make_port()
    convert.load_posenet(name, before, _np_tree(params), _np_tree(stats))
    moved = max(float((v - before.state_dict()[k]).abs().max())
                for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked"))
    assert moved > 1e-3  # the two steps moved the net
