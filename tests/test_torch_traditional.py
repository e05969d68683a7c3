"""The traditional augmenter (``--data_enhancement_method normal``) of the
port against dhaug_tpu/gan/traditional.py on the CPU: the JAX draws are
re-derived from its key with the same jax.random.split calls and fed to the
port's draw-taking function.  Also the pose pool and the replay pool."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch.gan import replay as t_replay
from dhaug_torch.gan import traditional as t_trad
from dhaug_torch.gan.wgan import camera_bank as t_camera_bank
from dhaug_torch.train.config import parse_aug_args as t_args
from dhaug_torch.train.data_prep import prepare_data as t_prepare
from dhaug_torch.train.data_prep import world_pose_pool as t_pool
from dhaug_tpu.gan import replay as j_replay
from dhaug_tpu.gan import traditional as j_trad
from dhaug_tpu.gan.wgan import camera_bank as j_camera_bank
from dhaug_tpu.models.generator import sample_scaler8 as j_scaler8
from dhaug_tpu.train.config import parse_aug_args as j_args
from dhaug_tpu.train.data_prep import prepare_data as j_prepare
from dhaug_tpu.train.data_prep import world_pose_pool as j_pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
POSE_TOL = 1e-5     # metres
PROJ_TOL = 1e-5


@pytest.fixture(scope="module")
def bundles():
    argv = ["--data_root", REPO]
    return t_prepare(t_args(argv)), j_prepare(j_args(argv))


@pytest.fixture(scope="module")
def pool(bundles):
    return t_pool(bundles[0], seed=0)


def _jax_draws(key, n, pool_size, scaler_mode):
    """The draws of generate_traditional_poses(key, ...), split as it splits
    its key (dhaug_tpu/gan/traditional.py:59-114)."""
    k_ang, k_bl, k_root, k_scaler = jax.random.split(key, 4)
    k_count, k_rank, k_norm, k_glob = jax.random.split(k_ang, 4)
    arrays = dict(
        count=jax.random.randint(k_count, (n, 1), 0, 34),
        scores=jax.random.uniform(k_rank, (n, 34)),
        angle_normal=jax.random.normal(k_norm, (n, 34)),
        global_normal=jax.random.normal(k_glob, (n, 3)),
        bl_idx=jax.random.randint(k_bl, (n,), 0, pool_size),
        root_idx=jax.random.randint(k_root, (n,), 0, pool_size),
        scaler8=j_scaler8(k_scaler, n, scaler_mode))
    return t_trad.TraditionalDraws(**{k: torch.as_tensor(np.array(v))
                                      for k, v in arrays.items()})


@pytest.mark.parametrize("cfg", [
    t_trad.TraditionalConfig(n_poses=N),
    t_trad.TraditionalConfig(n_poses=N, use_dataset_bone_len=False, use_dataset_root=False,
                             use_global_rot=False, bone_len_scaler="same"),
    t_trad.TraditionalConfig(n_poses=N, bone_len_scaler=""),
], ids=["defaults", "canonical-same", "no-scaler"])
def test_poses_match_jax_on_the_same_draws(cfg, pool):
    key = jax.random.PRNGKey(11)
    ref = j_trad.generate_traditional_poses(key, jnp.asarray(pool), j_trad.TraditionalConfig(
        *cfg))
    got = t_trad.traditional_poses_from_draws(
        _jax_draws(key, N, pool.shape[0], cfg.bone_len_scaler), torch.from_numpy(pool), cfg)
    for name, g, r, tol in zip(("pose16", "angles33", "global_rot", "bone_len", "root"),
                               got, ref, (POSE_TOL, 1e-4, 1e-4, 1e-6, 0.0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol, rtol=0, err_msg=name)
    assert float(got[1][0].abs().max()) == 0.0 and float(got[2][0].abs().max()) == 0.0


def test_projection_through_every_camera_matches_jax(pool):
    subjects = ["S1", "S5", "S6", "S7", "S8"]
    g = torch.Generator()
    g.manual_seed(0)
    pose16, *_ = t_trad.generate_traditional_poses(g, torch.from_numpy(pool),
                                                   t_trad.TraditionalConfig(n_poses=N))
    f3d, f2d = t_trad.project_through_cameras(pose16, *t_camera_bank(subjects))
    r3d, r2d = j_trad.project_through_cameras(jnp.asarray(pose16.numpy()),
                                              *j_camera_bank(subjects))
    assert f3d.shape == (20 * N, 16, 3) and f2d.shape == (20 * N, 16, 2)
    np.testing.assert_allclose(f3d.numpy(), np.asarray(r3d), atol=PROJ_TOL, rtol=0)
    np.testing.assert_allclose(f2d.numpy(), np.asarray(r2d), atol=PROJ_TOL, rtol=0)


def test_draws_come_from_the_generator(pool):
    cfg = t_trad.TraditionalConfig(n_poses=N)

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return t_trad.generate_traditional_poses(g, torch.from_numpy(pool), cfg)[0]

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (N, 16, 3) and bool(torch.isfinite(a).all())


@pytest.mark.parametrize("max_poses", [20000, 1000])
def test_world_pose_pool_matches_jax(bundles, max_poses):
    t_bundle, j_bundle = bundles
    got = t_pool(t_bundle, max_poses=max_poses, seed=5)
    ref = j_pool(j_bundle, max_poses=max_poses, seed=5)
    assert got.shape == ref.shape == (min(max_poses, 4800), 16, 3)
    np.testing.assert_array_equal(got, ref)


def test_replay_pool_matches_jax():
    rng = np.random.default_rng(0)
    t_pool_, j_pool_ = t_replay.SampleFromPool(40, seed=2), j_replay.SampleFromPool(40, seed=2)
    for _ in range(4):
        batch = rng.normal(size=(24, 16, 3)).astype(np.float32)
        np.testing.assert_array_equal(t_pool_(batch), j_pool_(batch))
    np.testing.assert_array_equal(t_pool_.items, j_pool_.items)
