"""Bulk synthesis in the port (dhaug_torch/parallel/sharded.py and
``python -m dhaug_torch.synthesize_dataset``) on the CPU, held to the JAX
chain of scripts/synthesize_dataset.py on injected draws.

Tolerance of the chain: the heads agree to fp32 summation order (see
tests/test_torch_trunk.py), and FK and the camera run in fp32 on both
sides.  The generator's root (up to 10 m) and the camera's translation put
coordinates at up to ~20 m, where one fp32 ulp is 1.9e-6 m; measured at
most 6.7e-6 m (cam3d) and 3.8e-6 (normalized 2D), intrinsics exact.  Held
to 1e-5 absolute plus 1e-6 relative (about 8 fp32 ulps of the value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dhaug_torch import synthesize_dataset
from dhaug_torch.gan.wgan import camera_bank
from dhaug_torch.models import convert, generator, trunk_cuda
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
from dhaug_torch.ops import fk_cuda
from dhaug_torch.ops.bones import bone_lengths_fk
from dhaug_torch.ops.camera import project_to_2d, world_to_camera_batch
from dhaug_torch.ops.fk import CANONICAL_BONE_LEN
from dhaug_torch.parallel.sharded import make_sharded_synthesizer
from dhaug_torch.utils.checkpoint import save_snapshot
from dhaug_tpu.gan.wgan import camera_bank as j_camera_bank
from dhaug_tpu.models import generator as j_gen
from dhaug_tpu.models.trunk_pallas import trunk_forward_pallas
from dhaug_tpu.ops.camera import project_to_2d as j_project, world_to_camera_batch as j_w2c

TOL = 1e-5
RTOL = 1e-6
SUBJECTS = ["S1", "S5", "S6", "S7", "S8"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These runs are too small to gain from torch's intra-op threads, and
    under a parallel test run those threads oversubscribe the cores and
    slow every process on them; the setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_synthesis_body_matches_the_jax_chain():
    dense, B = 48, 64
    rng = np.random.default_rng(0)
    net = j_gen.FkGeneratorNet(j_gen.GeneratorConfig(dense_dim=dense))
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((2, 128)))["params"]
    port = convert.load_generator(FkGeneratorNet(GeneratorConfig(dense_dim=dense)),
                                  jax.tree.map(np.asarray, params))
    noise = rng.normal(size=(B, 128)).astype(np.float32)
    scaler8 = (rng.integers(-200, 200, (B, 8)) / 1000.0).astype(np.float32)
    bone_len = rng.uniform(0.1, 0.6, (B, 15)).astype(np.float32)
    cam_idx = 13

    head = trunk_forward_pallas(params, jnp.asarray(noise), interpret=True)
    pose = j_gen.synthesize_poses(head, jnp.asarray(bone_len), jnp.asarray(scaler8),
                                  j_gen.GeneratorConfig(dense_dim=dense))
    quats, trans, intrs = j_camera_bank(SUBJECTS)
    cam3d = j_w2c(pose, quats[cam_idx][None], trans[cam_idx][None])
    intr = jnp.broadcast_to(intrs[cam_idx][None], (B, 9))
    pose2d = j_project(cam3d, intr)

    synthesize = make_sharded_synthesizer(GeneratorConfig(dense_dim=dense))
    got = synthesize_dataset.synth_pairs(
        synthesize, trunk_cuda.trunk_weights(port), torch.from_numpy(bone_len),
        camera_bank(SUBJECTS), None, noise=torch.from_numpy(noise),
        scaler8=torch.from_numpy(scaler8), cam_idx=cam_idx)
    for g, r in zip(got, (cam3d, pose2d, intr)):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=RTOL)


def _canonical():
    return torch.tensor(CANONICAL_BONE_LEN, dtype=torch.float32)


def _dispatch_inputs(dense=32, B=16, seed=0):
    cfg = GeneratorConfig(dense_dim=dense)
    torch.manual_seed(seed)
    ops = trunk_cuda.trunk_weights(FkGeneratorNet(cfg))
    return (make_sharded_synthesizer(cfg), ops, _canonical().expand(B, 15).contiguous(),
            camera_bank(SUBJECTS))


def test_a_dispatch_reads_nothing_back_to_the_host():
    """A synthesis dispatch makes no host read of a device value (on a
    card each one drains the queue the host dispatched ahead); the camera
    index used to make three."""
    synthesize, ops, bone_len, cameras = _dispatch_inputs()
    g = torch.Generator().manual_seed(1)
    synthesize_dataset.synth_pairs(synthesize, ops, bone_len, cameras, g)  # warm: tables
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        synthesize_dataset.synth_pairs(synthesize, ops, bone_len, cameras, g)
    names = [e.name for e in prof.events()]
    assert "synth.dispatch" in names  # the profile saw the dispatch
    assert names.count("aten::item") == 0
    assert names.count("aten::_local_scalar_dense") == 0


def test_generator_tables_are_uploaded_once_a_device_and_dtype():
    """head_to_angles and scale_bone_lengths take their constant tables
    from one cache keyed by (device, dtype): the second call on a device
    uploads nothing and gets the same tensors, and the outputs equal those
    of tables made afresh."""
    cfg = GeneratorConfig()
    head = torch.randn(8, 35, generator=torch.Generator().manual_seed(0))
    bone_len = torch.rand(8, 15) + 0.1
    scaler8 = torch.randint(-200, 200, (8, 8), generator=torch.Generator().manual_seed(1)) / 1e3
    generator._table.cache_clear()
    first = (generator.head_to_angles(head, cfg), generator.scale_bone_lengths(bone_len, scaler8))
    again = (generator.head_to_angles(head, cfg), generator.scale_bone_lengths(bone_len, scaler8))
    info = generator._table.cache_info()
    assert (info.misses, info.hits) == (4, 4)  # 4 tables made by the first call, reused
    assert generator._table("slots", head.device) is generator._table("slots", head.device)
    assert generator._table("scaler_groups", scaler8.device, torch.float64).dtype == torch.float64
    (angles, root), scaled = again
    assert torch.equal(angles, first[0][0]) and torch.equal(root, first[0][1])
    assert torch.equal(scaled, first[1])
    # the tables made afresh on every call, as before the cache
    fresh = head.new_zeros(8, 37).index_copy(
        -1, torch.as_tensor(generator.NONZERO_SLOTS), torch.tanh(head)[:, :31])
    fresh = (fresh * torch.as_tensor(generator.GAN_RANGE_SCALE)
             + torch.as_tensor(generator.GAN_RANGE_MID))
    assert torch.equal(angles, fresh)
    groups = torch.as_tensor(generator._SCALER_GROUPS, dtype=scaler8.dtype)
    assert torch.equal(scaled, bone_len * (1.0 + torch.einsum("gb,...g->...b", groups, scaler8)))


@pytest.mark.parametrize("index", ["tensor", "int"])
def test_dispatch_camera_equals_the_indexed_bank(index):
    """The camera gathered on the device (index_select) gives exactly what
    indexing the bank with the camera's number gives, for every camera."""
    synthesize, ops, bone_len, cameras = _dispatch_inputs(B=8)
    quats, trans, intrs = cameras
    rng = np.random.default_rng(3)
    noise = torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32))
    scaler8 = torch.from_numpy((rng.integers(-200, 200, (8, 8)) / 1000.0).astype(np.float32))
    pose16 = synthesize(ops, bone_len, None, noise=noise, scaler8=scaler8)
    for i in range(quats.shape[0]):
        cam_idx = torch.tensor(i) if index == "tensor" else i
        got = synthesize_dataset.synth_pairs(synthesize, ops, bone_len, cameras, None,
                                             noise=noise, scaler8=scaler8, cam_idx=cam_idx)
        cam3d = world_to_camera_batch(pose16, quats[i][None], trans[i][None])
        intr = intrs[i][None].expand(8, 9)
        want = (cam3d, project_to_2d(cam3d, intr), intr)
        assert all(tuple(g.shape) == tuple(w.shape) and torch.equal(g, w)
                   for g, w in zip(got, want))


def test_cpu_run_writes_the_jax_npz(tmp_path):
    out = tmp_path / "dh_synth.npz"
    f0, t0 = fk_cuda.FWD_LAUNCHES, trunk_cuda.TRUNK_LAUNCHES
    result = synthesize_dataset.main([
        "--device", "cpu", "--random_init", "true", "--Gen_DenseDim", "32",
        "--n_poses", "300", "--batch", "128", "--out", str(out)])
    assert (fk_cuda.FWD_LAUNCHES, trunk_cuda.TRUNK_LAUNCHES) == (f0, t0)  # CPU: no kernel
    assert result["n_poses"] == 300 and result["poses_per_s"] > 0
    data = np.load(out)
    assert sorted(data.files) == ["cam", "n_devices", "pose2d", "pose3d", "seed"]
    assert data["pose3d"].shape == (300, 16, 3) and data["pose3d"].dtype == np.float32
    assert data["pose2d"].shape == (300, 16, 2)
    assert data["cam"].shape == (300, 9)
    assert int(data["seed"]) == 0 and int(data["n_devices"]) == 1
    assert all(np.isfinite(data[k]).all() for k in ("pose3d", "pose2d", "cam"))
    # the camera is rigid, so every bone keeps its scaled length: within
    # the scaler range [0.8, 1.2) of the input, the thorax never scaled.
    # In metres: fp32 camera coordinates reach ~20 m (ulp 1.9e-6 m), and
    # a length is the difference of two of them (measured at most 6.0e-6 m
    # over 65536 poses)
    lengths = bone_lengths_fk(torch.from_numpy(data["pose3d"]))
    bl = _canonical()
    assert bool((lengths >= 0.8 * bl - TOL).all() and (lengths < 1.2 * bl).all())
    torch.testing.assert_close(lengths[:, 7], bl[7].expand(300), atol=TOL, rtol=0)


@pytest.mark.parametrize("layout", ["gen_state", "gen"])
def test_ckpt_loads_the_snapshot_generator_exactly(tmp_path, layout):
    torch.manual_seed(5)
    net = FkGeneratorNet(GeneratorConfig(dense_dim=32))
    state = {"model": net.state_dict()} if layout == "gen_state" else net.state_dict()
    path = save_snapshot({"epoch": 1, layout: state}, str(tmp_path), suffix="resume_latest")
    result = synthesize_dataset.main([
        "--device", "cpu", "--ckpt", path, "--Gen_DenseDim", "32", "--n_poses", "20",
        "--batch", "16", "--out", str(tmp_path / "s.npz")])
    loaded = result["generator"].state_dict()
    assert list(loaded) == list(net.state_dict())
    assert all(torch.equal(loaded[k], v) for k, v in net.state_dict().items())


@pytest.mark.parametrize("flags", [["--coordinator", "localhost:1234"],
                                   ["--num_processes", "2"]])
def test_multi_process_flags_are_refused(flags, tmp_path):
    """Multi-process synthesis needs both flags: half of the pair is
    refused before any work (tests/test_torch_parallel.py runs the pair)."""
    with pytest.raises(SystemExit, match="needs both --coordinator"):
        synthesize_dataset.main(["--device", "cpu", "--out", str(tmp_path / "s.npz")] + flags)
    assert not (tmp_path / "s.npz").exists()


def test_more_than_one_device_is_refused():
    """Over several devices a batch must split into whole shards, one
    generator each; outside a group the shards run in turn and their rows
    come back in shard order."""
    cfg = GeneratorConfig(dense_dim=32)
    synthesize = make_sharded_synthesizer(cfg, n_devices=2)
    torch.manual_seed(0)
    ops = trunk_cuda.trunk_weights(FkGeneratorNet(cfg))
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    with pytest.raises(ValueError, match="divisible by 2"):
        synthesize(ops, _canonical().expand(3, 15).contiguous(), gens)
    with pytest.raises(ValueError, match="2 generators"):
        synthesize(ops, _canonical().expand(4, 15).contiguous(), gens[:1])
    with pytest.raises(ValueError, match="at least 1"):
        make_sharded_synthesizer(cfg, n_devices=0)
    one = make_sharded_synthesizer(cfg)
    bl = _canonical().expand(4, 15).contiguous()
    got = synthesize(ops, bl, [torch.Generator().manual_seed(s) for s in (1, 2)])
    want = torch.cat([one(ops, bl[:2], torch.Generator().manual_seed(s)) for s in (1, 2)])
    assert torch.equal(got, want)


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesize_dataset.main(["--random_init", "true", "--Gen_DenseDim", "32",
                                 "--out", str(tmp_path / "s.npz")])
