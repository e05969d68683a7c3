"""dhaug_torch geometry, bones and metrics against dhaug_tpu.ops (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch.ops import augment as t_augment
from dhaug_torch.ops import bones as t_bones
from dhaug_torch.ops import camera as t_camera
from dhaug_torch.ops import metrics as t_metrics
from dhaug_torch.ops import quaternion as t_quat
from dhaug_tpu.ops import augment as j_augment
from dhaug_tpu.ops import bones as j_bones
from dhaug_tpu.ops import camera as j_camera
from dhaug_tpu.ops import metrics as j_metrics
from dhaug_tpu.ops import quaternion as j_quat

TOL = 1e-6


def _pair(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(j, t, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _poses(rng, n, scale=0.3):
    return rng.normal(size=(n, 16, 3)) * scale


def test_qrot_qinverse():
    rng = np.random.default_rng(0)
    qj, qt = _pair(_unit_quats(rng, 32))
    vj, vt = _pair(rng.normal(size=(32, 3)))
    _close(j_quat.qrot(qj, vj), t_quat.qrot(qt, vt))
    _close(j_quat.qinverse(qj), t_quat.qinverse(qt))


def test_world_camera_round_trip_and_parity():
    rng = np.random.default_rng(1)
    Xj, Xt = _pair(_poses(rng, 24) + np.array([0.0, 0.0, 5.0]))
    qj, qt = _pair(_unit_quats(rng, 24))
    tj, tt = _pair(rng.normal(size=(24, 3)))
    cam_j = j_camera.world_to_camera_batch(Xj, qj, tj)
    cam_t = t_camera.world_to_camera_batch(Xt, qt, tt)
    _close(cam_j, cam_t)
    _close(j_camera.camera_to_world_batch(cam_j, qj, tj),
           t_camera.camera_to_world_batch(cam_t, qt, tt))
    _close(Xj, t_camera.camera_to_world_batch(cam_t, qt, tt), tol=1e-5)


def test_project_to_2d_values_and_clamp_gradient():
    rng = np.random.default_rng(2)
    X = _poses(rng, 16, 0.5) + np.array([0.0, 0.0, 3.0])
    # points exactly on (x/z = 1.0, -1.0) and beyond the clamp
    X[0, 0] = (3.0, -3.0, 3.0)
    X[0, 1] = (7.0, 0.2, 2.0)
    cams = np.concatenate([rng.uniform(0.5, 2.5, (16, 2)), rng.normal(size=(16, 2)) * 0.1,
                           rng.normal(size=(16, 3)) * 0.1, rng.normal(size=(16, 2)) * 0.01],
                          axis=1)
    Xj, Xt = _pair(X)
    cj, ct = _pair(cams)
    _close(j_camera.project_to_2d(Xj, cj), t_camera.project_to_2d(Xt, ct))

    w = rng.normal(size=(16, 16, 2)).astype(np.float32)
    gj = jax.grad(lambda x: jnp.sum(j_camera.project_to_2d(x, cj) * w))(Xj)
    Xt.requires_grad_(True)
    (gt,) = torch.autograd.grad((t_camera.project_to_2d(Xt, ct) * torch.from_numpy(w)).sum(), Xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5, rtol=1e-5)


def test_project_to_2d_at_zero_depth_keeps_a_finite_gradient():
    """A point at a depth of exactly 0 (the video generator's fake clips
    meet one now and then): the plain divide's value, +-inf clamped to +-1,
    and the clamp's gradient of 0 where the plain divide's is NaN
    (0 x inf); every other point as the JAX port's."""
    rng = np.random.default_rng(4)
    X = _poses(rng, 4, 0.5) + np.array([0.0, 0.0, 3.0])
    X[1, 3] = (0.4, -0.7, 0.0)
    cams = np.concatenate([rng.uniform(0.5, 2.5, (4, 2)), rng.normal(size=(4, 2)) * 0.1,
                           rng.normal(size=(4, 3)) * 0.1, rng.normal(size=(4, 2)) * 0.01],
                          axis=1)
    w = rng.normal(size=(4, 16, 2)).astype(np.float32)
    Xj, Xt = _pair(X)
    cj, ct = _pair(cams)
    Xt.requires_grad_(True)
    out = t_camera.project_to_2d(Xt, ct)
    with torch.no_grad():
        assert torch.equal(out, t_camera.project_to_2d(Xt, ct))
    assert torch.isfinite(out).all()
    (gt,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), Xt)
    assert torch.isfinite(gt).all() and not gt[1, 3].any()

    (plain,) = torch.autograd.grad(t_camera.clip_unit(Xt[..., :2] / Xt[..., 2:]).sum(), Xt)
    assert torch.isnan(plain[1, 3]).any()

    gj = np.asarray(jax.grad(lambda x: jnp.sum(j_camera.project_to_2d(x, cj) * w))(Xj))
    others = np.ones((4, 16), bool)
    others[1, 3] = False
    np.testing.assert_allclose(gt.numpy()[others], gj[others], atol=1e-5, rtol=1e-5)


def test_clip_unit_gradient_matches_jnp_clip():
    x = np.array([-2.0, -1.0, -0.5, 0.0, 1.0, 3.0], np.float32)
    gj = jax.grad(lambda v: jnp.sum(jnp.clip(v, -1.0, 1.0)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (gt,) = torch.autograd.grad(t_camera.clip_unit(xt).sum(), xt)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert gt.numpy().tolist() == [0.0, 0.5, 1.0, 1.0, 0.5, 0.0]


@pytest.mark.parametrize("channels", [2, 3])
def test_flip_pose(channels):
    rng = np.random.default_rng(3)
    pj, pt = _pair(rng.normal(size=(8, 16, channels)))
    _close(j_augment.flip_pose(pj), t_augment.flip_pose(pt), tol=0)


def test_bones_and_kcs():
    rng = np.random.default_rng(4)
    pj, pt = _pair(_poses(rng, 40))
    _close(j_bones.bone_vectors_fk(pj), t_bones.bone_vectors_fk(pt))
    _close(j_bones.bone_vectors_tree(pj), t_bones.bone_vectors_tree(pt))
    _close(j_bones.bone_lengths_fk(pj), t_bones.bone_lengths_fk(pt))
    _close(j_bones.kcs_features(pj, with_lengths=True), t_bones.kcs_features(pt), tol=1e-5)


def test_reskin_pose():
    rng = np.random.default_rng(5)
    pj, pt = _pair(_poses(rng, 40))
    lj, lt = _pair(rng.uniform(0.1, 0.5, (40, 15)))
    out_t = t_bones.reskin_pose(pt, lt)
    _close(j_bones.reskin_pose(pj, lj), out_t)
    # the new tree-order lengths are exactly the requested ones
    _close(lj, t_bones.bone_lengths(t_bones.bone_vectors_tree(out_t)), tol=1e-6)


def test_metrics():
    rng = np.random.default_rng(6)
    tj, tt = _pair(_poses(rng, 64))
    yj, yt = _pair(_poses(rng, 64) * 0.5 + np.asarray(tj))
    _close(j_metrics.mpjpe(yj, tj), t_metrics.mpjpe(yt, tt))
    _close(j_metrics.p_mpjpe_per_sample(yj, tj), t_metrics.p_mpjpe_per_sample(yt, tt))


def test_p_mpjpe_of_similarity_transform_is_zero():
    rng = np.random.default_rng(7)
    target = torch.from_numpy(_poses(rng, 8).astype(np.float32))
    q = torch.from_numpy(_unit_quats(rng, 8).astype(np.float32))
    moved = 1.7 * t_quat.qrot(q[:, None, :], target) + 0.3
    assert float(t_metrics.p_mpjpe_per_sample(moved, target).abs().max()) < 1e-5
