"""The library functions no CLI calls, in dhaug_torch against dhaug_tpu (CPU):
camera helpers, bone unit vectors and the 9-ratio re-skin, the zero-angle
FK fixture and the bone names, the per-joint/weighted MPJPE and rectified
losses, the plateau scheduler and the learning-rate read-back, the
containers' epoch samplers and pad_to_batch, the clip sampler's device
epoch, the skeleton's metadata, the WGAN helpers (tiled camera records,
critic accuracy, the standalone gradient penalty), the running mean and the
progress line.  Inputs are seeded numpy arrays fed to both packages."""
import io
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch import make_fk_inspector
from dhaug_torch.data import chunked as t_chunked
from dhaug_torch.data import h36m as t_h36m
from dhaug_torch.data import loaders as t_loaders
from dhaug_torch.gan import wgan as t_wgan
from dhaug_torch.models import convert
from dhaug_torch.models import discriminators as t_disc
from dhaug_torch.ops import bones as t_bones
from dhaug_torch.ops import camera as t_camera
from dhaug_torch.ops import fk as t_fk
from dhaug_torch.ops import metrics as t_metrics
from dhaug_torch.train import state as t_state
from dhaug_torch.utils import log as t_log
from dhaug_tpu.data import chunked as j_chunked
from dhaug_tpu.data import h36m as j_h36m
from dhaug_tpu.data import loaders as j_loaders
from dhaug_tpu.gan import wgan as j_wgan
from dhaug_tpu.models import discriminators as j_disc
from dhaug_tpu.ops import bones as j_bones
from dhaug_tpu.ops import camera as j_camera
from dhaug_tpu.ops import fk as j_fk
from dhaug_tpu.ops import metrics as j_metrics
from dhaug_tpu.train import state as j_state
from dhaug_tpu.utils import log as j_log


def _both(fn_j, fn_t, *arrays):
    """fn_j on jnp copies and fn_t on torch copies of the float32 arrays."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    got = fn_t(*(torch.from_numpy(a.copy()) for a in arrays))
    want = fn_j(*(jnp.asarray(a) for a in arrays))
    return np.asarray(got), np.asarray(want)


def _poses(rng, n, scale=0.3):
    return rng.normal(size=(n, 16, 3)) * scale


# camera: rtol 1e-6

@pytest.mark.parametrize("name", ["normalize_screen_coordinates", "image_coordinates"])
def test_screen_coordinate_maps(name):
    rng = np.random.default_rng(0)
    points = rng.uniform(0, 1000, (7, 16, 2))
    got, want = _both(lambda p: getattr(j_camera, name)(p, 1000, 1002),
                      lambda p: getattr(t_camera, name)(p, 1000, 1002), points)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_screen_coordinates_round_trip():
    points = torch.from_numpy(np.random.default_rng(1).uniform(0, 1000, (5, 16, 2)))
    back = t_camera.image_coordinates(
        t_camera.normalize_screen_coordinates(points, 1000, 1002), 1000, 1002)
    np.testing.assert_allclose(back.numpy(), points.numpy(), rtol=1e-12)


def test_project_to_2d_linear():
    rng = np.random.default_rng(2)
    X = _poses(rng, 6) + np.array([0.0, 0.0, 5.0])
    X[0, 0] = [9.0, -9.0, 1.0]          # a divide clamped at both bounds
    cams = rng.uniform(0.1, 2.0, (6, 9))
    got, want = _both(j_camera.project_to_2d_linear, t_camera.project_to_2d_linear, X, cams)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# bones: 1e-6

def test_bone_unit_vectors_tree():
    got, want = _both(j_bones.bone_unit_vectors_tree, t_bones.bone_unit_vectors_tree,
                      _poses(np.random.default_rng(3), 9))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_blaugment9to15():
    rng = np.random.default_rng(4)
    pose, bl, blr9 = _poses(rng, 8), rng.uniform(0.1, 0.6, (8, 15)), rng.uniform(-0.2, 0.2,
                                                                                 (8, 9))
    got, want = _both(j_bones.blaugment9to15, t_bones.blaugment9to15, pose, bl, blr9)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # mirrored bones share a ratio: left and right legs scale alike
    lengths = t_bones.bone_lengths(t_bones.bone_vectors_tree(torch.from_numpy(got))).numpy()
    np.testing.assert_allclose(lengths[:, 0] / bl[:, 0], lengths[:, 3] / bl[:, 3], rtol=1e-5)


# fk: 2.4e-7 m (PARITY.md:11)

def test_init_fk_dh_angle():
    got = t_fk.init_fk_dh_angle()
    assert got.shape == (32, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_fk.init_fk_dh_angle()),
                               atol=2.4e-7, rtol=0)


def test_fk_tables_match_the_jax_package():
    assert t_fk.BONE_NAMES == j_fk.BONE_NAMES
    for chain, (alpha, theta, (lo, hi)) in t_fk.CHAINS.items():
        prefix = chain.upper()
        a, d = make_fk_inspector.LINK_LENGTHS[chain]
        assert (alpha, a, d, theta) == tuple(getattr(j_fk, f"{prefix}_{k}")
                                             for k in ("ALPHA", "A", "D", "THETA"))
        assert slice(lo, hi) == getattr(j_fk, f"{prefix}_SLICE")


# metrics: rtol 1e-6

@pytest.mark.parametrize("name", ["mpjpe_by_joint", "weighted_mpjpe", "diff_range_loss",
                                  "rectified_l2_loss"])
def test_metric(name):
    rng = np.random.default_rng(5)
    a, b = _poses(rng, 10), _poses(rng, 10)
    args = {"mpjpe_by_joint": (a, b), "weighted_mpjpe": (a, b, rng.uniform(0, 2, (10, 16))),
            "diff_range_loss": (a, b, rng.uniform(0.1, 0.5, (16, 3))),
            "rectified_l2_loss": (a, rng.uniform(0.1, 0.5, (16, 3)))}[name]
    got, want = _both(getattr(j_metrics, name), getattr(t_metrics, name), *args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if name in ("diff_range_loss", "rectified_l2_loss"):
        assert 0 < got < np.mean((args[0] - (args[1] if name == "diff_range_loss" else 0)) ** 2)


# train state

def test_plateau_scheduler_lr_sequence():
    metrics = [10.0, 9.0, 9.0, 8.95, 9.5, 9.2, 9.1, 9.0, 8.99, 7.0, 7.0, 7.0, 7.0, 7.0,
               7.0, 7.0, 6.99, 6.0, 6.5, 6.5, 6.5, 6.5, 6.5, 6.5, 6.5]
    j, t = j_state.PlateauScheduler(1e-3), t_state.PlateauScheduler(1e-3)
    j_lrs, t_lrs = [j.step(m) for m in metrics], [t.step(m) for m in metrics]
    assert t_lrs == j_lrs
    assert len(set(t_lrs)) == 4     # three reductions in the stream


def test_current_learning_rate_reads_what_set_learning_rate_wrote():
    """Equal to the JAX read-back, which holds the rate in float32."""
    w = torch.nn.Parameter(torch.zeros(3))
    opt = t_state.adam_posenet([w], 1e-3)
    state = j_state.make_state(j_state.adam_posenet(1e-3), {"w": jnp.zeros(3)})
    assert t_state.current_learning_rate(opt) == 1e-3
    for lr in (2.5e-4, 1.7e-5):
        t_state.set_learning_rate(opt, lr)
        state = j_state.set_learning_rate(state, lr)
        assert t_state.current_learning_rate(opt) == lr
        assert np.float32(t_state.current_learning_rate(opt)) == \
            j_state.current_learning_rate(state)


# loaders: identical arrays under the same numpy seed

def _batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_pose_target_2d_batches(shuffle, drop_last):
    parts = [np.random.default_rng(6).normal(size=(n, 16, 2)) for n in (30, 23)]
    t, j = t_loaders.PoseTarget2D.from_lists(parts), j_loaders.PoseTarget2D.from_lists(parts)
    np.testing.assert_array_equal(t.poses_2d, j.poses_2d)
    assert len(t) == len(j) == 53
    _batches_equal(t.batches(np.random.default_rng(7), 16, shuffle, drop_last),
                   j.batches(np.random.default_rng(7), 16, shuffle, drop_last))


@pytest.mark.parametrize("drop_last", [True, False])
def test_cmu_pose_target_batches(drop_last):
    rng = np.random.default_rng(8)
    arrays = (rng.normal(size=(41, 16, 3)), rng.normal(size=(41, 16, 2)),
              rng.normal(size=(5, 9)))
    t, j = t_loaders.CmuPoseTarget(*arrays), j_loaders.CmuPoseTarget(*arrays)
    assert len(t) == len(j)
    _batches_equal(t.batches(np.random.default_rng(9), 8, drop_last),
                   j.batches(np.random.default_rng(9), 8, drop_last))


@pytest.mark.parametrize("n", [12, 13])
def test_pad_to_batch(n):
    rng = np.random.default_rng(10)
    arrays = [rng.normal(size=(n, 16, 2)), rng.normal(size=(n, 3))]
    (got, got_n), (want, want_n) = (t_loaders.pad_to_batch(arrays, 4),
                                    j_loaders.pad_to_batch(arrays, 4))
    assert got_n == want_n == n
    for g, w in zip(got, want):
        assert g.shape[0] % 4 == 0
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_pose_dataset_and_target_batches(shuffle, drop_last):
    rng = np.random.default_rng(14)
    parts = ([rng.normal(size=(n, 16, 3)) for n in (19, 22)],
             [rng.normal(size=(n, 16, 2)) for n in (19, 22)],
             [rng.normal(size=(n, 9)) for n in (19, 22)])
    for cls, args in (("PoseDataset", parts), ("PoseTarget", parts[:1])):
        t = getattr(t_loaders, cls).from_lists(*args)
        j = getattr(j_loaders, cls).from_lists(*args)
        wrap = (lambda it: ((b,) for b in it)) if cls == "PoseTarget" else (lambda it: it)
        _batches_equal(wrap(t.batches(np.random.default_rng(15), 8, shuffle, drop_last)),
                       wrap(j.batches(np.random.default_rng(15), 8, shuffle, drop_last)))
    ds, jds = t_loaders.PoseDataset.from_lists(*parts), j_loaders.PoseDataset.from_lists(*parts)
    assert ds.num_batches(8, drop_last) == jds.num_batches(8, drop_last) == \
        (5 if drop_last else 6)
    buf = t_loaders.PoseBuffer.from_lists(*parts[:2])
    _batches_equal(buf.batches(8), j_loaders.PoseBuffer.from_lists(*parts[:2]).batches(8))


@pytest.mark.parametrize("full_3d_window,with_cams", [(True, True), (False, False)])
def test_chunk_windows_device_epoch(full_3d_window, with_cams):
    """The same batches as the JAX device epoch, and as the host epoch."""
    rng = np.random.default_rng(16)
    seq3d = [rng.normal(size=(n, 16, 3)) for n in (23, 17, 30)]
    seq2d = [rng.normal(size=(n, 16, 2)) for n in (23, 17, 30)]
    cams = [rng.normal(size=9) for _ in range(3)] if with_cams else None
    kw = dict(batch_size=8, cams=cams, poses_3d=seq3d, poses_2d=seq2d, pad=2,
              full_3d_window=full_3d_window, random_seed=5)
    t, j, host = (t_chunked.ChunkWindows(**kw), j_chunked.ChunkWindows(**kw),
                  t_chunked.ChunkWindows(**kw))
    got = [tuple(None if x is None else x.numpy() for x in b)
           for b in t.device_epoch(torch.device("cpu"))]
    assert len(got) == 70 // 8 and (got[0][0] is None) == (not with_cams)
    for want in (list(j.device_epoch()), list(host.next_epoch())):
        assert len(want) == len(got)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, np.asarray(b))


def test_skeleton_metadata():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "data", "data_3d_h36m.npz")
    t, j = t_h36m.Human36mDataset(path), j_h36m.Human36mDataset(path)
    assert t.fps() == j.fps() == 50
    ts, js = t.skeleton(), j.skeleton()
    for name in ("joints_left", "joints_right", "joints_group", "children"):
        assert getattr(ts, name)() == getattr(js, name)(), name
    np.testing.assert_array_equal(ts.has_children(), js.has_children())
    np.testing.assert_array_equal(ts.parents(), js.parents())
    assert ts.joints_group() == t_h36m.h36m_skeleton_joints_group


# gan helpers

def test_tiled_cam16():
    rng = np.random.default_rng(11)
    intr, quat, trans = rng.normal(size=9), rng.normal(size=4), rng.normal(size=3)
    got = t_wgan.tiled_cam16(intr, quat, trans, 5)
    assert got.shape == (5, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_wgan.tiled_cam16(intr, quat, trans, 5)))


def test_discriminator_accuracy():
    pred = np.random.default_rng(12).uniform(-1, 2, (64, 1)).astype(np.float32)
    for label in (0.0, 1.0):
        got = t_wgan.discriminator_accuracy(torch.from_numpy(pred), label)
        assert got == j_wgan.discriminator_accuracy(pred, label)
        assert 0.0 < got < 1.0


def test_gradient_penalty_against_jax_and_the_stacked_critic_step():
    """The standalone penalty with the JAX draw jax.random.uniform(key,
    (B, 1)) injected as alpha: equal to the JAX function (rtol 1e-5), and
    to the penalty critic_step computes from its stacked forward (1e-5)."""
    B, W = 16, 32
    d3d = j_disc.Fk3DDiscriminator(dense_dim=W)
    params = d3d.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 3)))["params"]
    critic = convert.load_d3d(t_disc.Fk3DDiscriminator(W),
                              jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(13)
    real = _poses(rng, B).astype(np.float32)
    fake = (real + rng.normal(size=real.shape) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = float(j_wgan.gradient_penalty(lambda p, x: d3d.apply({"params": p}, x), params,
                                         jnp.asarray(real), jnp.asarray(fake), key, 10.0))
    alpha = torch.from_numpy(np.array(jax.random.uniform(key, (B, 1))))
    got = t_wgan.gradient_penalty(critic, torch.from_numpy(real), torch.from_numpy(fake),
                                  10.0, alpha=alpha)
    assert got.requires_grad
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    stacked = t_wgan.critic_step(critic, torch.optim.SGD(critic.parameters(), lr=0.0),
                                 torch.from_numpy(real), torch.from_numpy(fake), 10.0,
                                 alpha=alpha)["gp"]
    np.testing.assert_allclose(float(stacked), float(got.detach()), rtol=1e-5)
    # a drawn alpha comes from the torch.Generator
    g = torch.Generator().manual_seed(0)
    again = t_wgan.gradient_penalty(critic, torch.from_numpy(real), torch.from_numpy(fake),
                                    10.0, generator=g)
    assert float(again.detach()) >= 0 and np.isfinite(float(again.detach()))


# logging

def test_average_meter():
    t, j = t_log.AverageMeter(), j_log.AverageMeter()
    for val, n in ((2.0, 1), (5.0, 3), (0.5, 4)):
        t.update(val, n)
        j.update(val, n)
        assert (t.val, t.sum, t.count, t.avg) == (j.val, j.sum, j.count, j.avg)
    t.reset()
    assert (t.val, t.avg, t.sum, t.count) == (0.0, 0.0, 0.0, 0)


def test_metrics_writer_flush(tmp_path):
    writer = t_log.MetricsWriter(str(tmp_path))
    writer.add_scalar("train/x", 1.5, 3)
    writer.flush()
    line = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert (line["tag"], line["value"], line["step"]) == ("train/x", 1.5, 3)
    writer.close()
    t_log.MetricsWriter(None).flush()       # writes nothing, raises nothing



def test_progress_meter_writes_the_jax_line(monkeypatch):
    clock = iter([100.0, 100.0, 103.5, 103.5, 110.0, 110.0])
    monkeypatch.setattr(time, "time", lambda: next(clock))
    out_t, out_j = io.StringIO(), io.StringIO()
    t, j = t_log.ProgressMeter("epoch 3", 20, out_t), j_log.ProgressMeter("epoch 3", 20, out_j)
    for meter in (t, j):
        meter.update(6, "| loss 0.25")
    for meter in (t, j):
        meter.update(13)
        meter.finish()
    assert out_t.getvalue() == out_j.getvalue()
    assert out_t.getvalue().startswith("\repoch 3 (7/20)    3.5s elapsed | ETA ")
