"""The port's measurement tools on the CPU, against the JAX package's:
``dhaug_torch.bench`` (its hand FLOP counts against ``bench.py``'s, its
three lines at tiny sizes, its ``--check`` bands and its refusals without a
card), ``bench_reference_torch`` against ``scripts/bench_reference_torch.py``,
``cost_analysis``'s counted FLOPs between the hand count and XLA's count of
the JAX steps, ``graft_entry``'s forward against ``__graft_entry__``'s and
its dry run on gloo ranks, the A/B and component benches at tiny sizes, and
``chip_smoke.py``'s bench-phase launch counts rehearsed with counting FK and
trunk stand-ins."""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch import (bench, bench_components, bench_fk_grad_ab, bench_reference_torch,
                         cost_analysis, graft_entry)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_BENCH = ["--device", "cpu", "--batch", "64", "--scan_steps", "2", "--dense", "32",
              "--iters", "2", "--gan_batch", "32", "--gan_scan", "3", "--gan_iters", "1",
              "--video_batch", "4", "--video_batches", "2", "--video_reps", "1",
              "--baseline_iters", "2"]


@pytest.fixture(autouse=True)
def one_thread():
    """In-process tests run one intra-op thread: under a parallel test run
    torch's default of one thread a core oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


@pytest.mark.parametrize("B,F,dense", [(1024, 9, 1000), (512, 27, 256), (32, 3, 64)])
def test_hand_counts_equal_bench_py(B, F, dense):
    jax_bench = _load("bench.py", "jax_bench")
    assert cost_analysis.gan_iter_flops(B, dense) == jax_bench._gan_iter_flops(B, dense)
    assert cost_analysis.video_iter_flops(B, F, dense) == \
        jax_bench._video_iter_flops(B, F, dense)
    assert cost_analysis.tower_fwd(B, 48, dense, 1) == jax_bench._tower_fwd(B, 48, dense, 1)


def test_bench_cli_prints_three_lines_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "dhaug_torch.bench", *TINY_BENCH],
                          capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [line["metric"].split(" ")[0] for line in lines] == ["video", "GAN", "augmented"]
    assert set(lines[-1]) == {"metric", "value", "unit", "vs_baseline"}
    assert lines[-1]["unit"] == "poses/s"
    for line in lines:
        numbers = [v for v in line.values() if isinstance(v, (int, float))]
        assert numbers and all(np.isfinite(v) and v > 0 for v in numbers)
    for line in lines[:2]:
        assert line["device"] == {"name": "cpu", "nvidia_smi": None}
        assert line["unit"] == "iters/s" and line["mfu_counted"] > line["mfu_lower_bound"]
        assert line["mfu_est"] == line["mfu_lower_bound"]


def test_check_regression_bands():
    """Each line raw against its own band: a line below (1 - tol) of its
    nominal fails alone, a missing line is skipped, and the recorded
    nominals pass themselves."""
    nom = {"synthesis_poses_per_sec": 10e6, "gan_iters_per_sec": 20.0,
           "video_iters_per_sec": 3.0}
    tol = {"synthesis": 0.3, "gan": 0.3, "video": 0.25}
    ok = {"synthesis": {"value": 7.1e6}, "gan": {"value": 14.1}, "video": {"value": 2.26}}
    assert bench.check_regression(ok, nom, tol) == []

    bad_gan = {"synthesis": {"value": 10e6}, "gan": {"value": 13.9}, "video": {"value": 3.0}}
    fails = bench.check_regression(bad_gan, nom, tol)
    assert len(fails) == 1 and fails[0].startswith("gan")

    bad_video = {"synthesis": {"value": 10e6}, "gan": {"value": 20.0}, "video": {"value": 2.2}}
    fails = bench.check_regression(bad_video, nom, tol)
    assert len(fails) == 1 and fails[0].startswith("video")

    syn_bad = {"synthesis": {"value": 6.9e6}, "gan": {"value": 20.0}, "video": None}
    fails = bench.check_regression(syn_bad, nom, tol)
    assert len(fails) == 1 and fails[0].startswith("synthesis")

    assert all(v > 0 for v in bench.CHECK_NOMINALS.values())
    assert bench.check_regression(
        {"synthesis": {"value": bench.CHECK_NOMINALS["synthesis_poses_per_sec"]},
         "gan": {"value": bench.CHECK_NOMINALS["gan_iters_per_sec"]},
         "video": {"value": bench.CHECK_NOMINALS["video_iters_per_sec"]}}) == []


@pytest.mark.parametrize("argv,rc,words", [(["--check"], 2, "needs an NVIDIA card"),
                                           ([], 1, "no CUDA device")])
def test_bench_without_a_card_refuses(argv, rc, words):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, "-m", "dhaug_torch.bench", *argv],
                          capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert proc.returncode == rc
    assert words in proc.stderr
    assert proc.stdout == ""


def test_reference_baseline_equals_the_jax_packages_script():
    """dh_matrix_batch, fk_reference_style and one synthesis batch of the
    port's copy give the JAX package's script's values on the CPU (the
    same operations in the same order: equal to float32 rounding, 1e-6)."""
    ref = _load("scripts/bench_reference_torch.py", "jax_bench_reference")
    rng = np.random.default_rng(0)
    B = 64
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    alpha, a, d, theta = (t(rng.uniform(-180, 180, B)), t(rng.uniform(0, 0.5, B)),
                          t(rng.uniform(0, 0.5, B)), t(rng.uniform(-180, 180, B)))
    torch.testing.assert_close(bench_reference_torch.dh_matrix_batch(alpha, a, d, theta),
                               ref.dh_matrix_batch(alpha, a, d, theta), atol=1e-6, rtol=0)
    angles, bone_len = t(rng.uniform(-120, 120, (B, 33))), t(rng.uniform(0.1, 0.7, (B, 15)))
    torch.testing.assert_close(bench_reference_torch.fk_reference_style(angles, bone_len, B),
                               ref.fk_reference_style(angles, bone_len, B), atol=1e-6, rtol=0)

    torch.manual_seed(0)
    trunk = bench_reference_torch.Trunk(64)
    torch.manual_seed(0)
    jax_trunk = ref.Trunk(64)
    z = t(rng.normal(size=(B, 128)))
    with torch.no_grad():
        pose16, pose2d = bench_reference_torch.synthesis_batch(trunk, bone_len, z)
        # the JAX package's script inlines this batch in main() (:399-417)
        head = jax_trunk(z)
        want16 = ref.fk_reference_style(torch.tanh(head[:, :33]) * 180.0, bone_len, B)[
            :, [0, 1, 2, 3, 6, 7, 8, 12, 13, 15, 17, 18, 19, 25, 26, 27]]
        f, c = torch.tensor([2.29, 2.287]), torch.tensor([0.025, 0.028])
        k, p = torch.tensor([-0.207, 0.247, -0.003]), torch.tensor([-0.001, -0.001])
        XX = torch.clamp((want16 + torch.tensor([0.0, 0.0, 4.0]))[..., :2]
                         / (want16 + torch.tensor([0.0, 0.0, 4.0]))[..., 2:], -1, 1)
        r2 = (XX ** 2).sum(-1, keepdim=True)
        radial = 1 + (k * torch.cat([r2, r2 ** 2, r2 ** 3], -1)).sum(-1, keepdim=True)
        want2d = f * (XX * (radial + (p * XX).sum(-1, keepdim=True)) + p * r2) + c
    torch.testing.assert_close(pose16, want16, atol=1e-6, rtol=0)
    torch.testing.assert_close(pose2d, want2d, atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", ["synthesis", "gan_iter", "video_gan_iter"])
def test_reference_baseline_modes_run_on_the_cpu(mode):
    out = bench_reference_torch.measure(mode, 8, 1, 16, torch.device("cpu"))
    assert out["device"] == "cpu" and out["value"] > 0 and np.isfinite(out["value"])


def _xla_single_frame_gflops(B, dense):
    """XLA's count of the JAX package's single-frame steps per iteration
    (critics + generator / 5), built as scripts/cost_analysis.py:40-83
    builds them, at batch B and width dense."""
    from dhaug_tpu.gan.wgan import GanHyper, camera_bank, make_single_frame_steps
    from dhaug_tpu.models.discriminators import Fk2DDiscriminator, Fk3DDiscriminator
    from dhaug_tpu.models.generator import FkGeneratorNet, GeneratorConfig
    from dhaug_tpu.train.state import adam_gan, make_state

    def flops(lowered):
        cost = lowered.compile().cost_analysis()
        return float((cost[0] if isinstance(cost, list) else cost).get("flops", 0.0))

    key = jax.random.PRNGKey(0)
    gen_cfg = GeneratorConfig(dense_dim=dense)
    gen, d3d, d2d = (FkGeneratorNet(gen_cfg), Fk3DDiscriminator(dense_dim=dense),
                     Fk2DDiscriminator(dense_dim=dense))
    gp = gen.init(key, jnp.zeros((2, 128)))["params"]
    p3 = d3d.init(key, jnp.zeros((2, 16, 3)))["params"]
    p2 = d2d.init(key, jnp.zeros((2, 16, 2)))["params"]
    txs = adam_gan(), adam_gan(), adam_gan()
    quats, trans, intrs = camera_bank(["S1"])
    steps = make_single_frame_steps(
        lambda p, x: gen.apply({"params": p}, x), lambda p, x: d3d.apply({"params": p}, x),
        lambda p, x: d2d.apply({"params": p}, x), txs[1], txs[2], txs[0], gen_cfg,
        GanHyper(flip=True, use_pallas_fk=False), quats, trans, intrs)
    sg, s3, s2 = make_state(txs[0], gp), make_state(txs[1], p3), make_state(txs[2], p2)
    critics = flops(jax.jit(steps.critics_step).lower(
        s3, s2, sg.params, jnp.zeros((B, 16, 3)), jnp.zeros((B, 16)), jnp.zeros((B, 16, 2)),
        key))
    generator = flops(steps.generator_step.lower(sg, s3.params, s2.params, jnp.zeros((B, 15)),
                                                 jnp.asarray(0, jnp.int32), key))
    return (critics + generator / 5.0) / 1e9


def test_counted_flops_lie_between_the_hand_count_and_xla():
    """At B = 32, D = 64: the hand count (dense layers, ~9 forward
    equivalents an update) <= FlopCounterMode's count of the port's steps
    (every matmul, the stacked 3B critic passes and the double backward)
    <= XLA's count of the JAX steps (elementwise work included)."""
    B, dense = 32, 64
    line = cost_analysis.single_frame(B, dense, "cpu", ms_per_iter=1.0)
    xla = _xla_single_frame_gflops(B, dense)
    assert line["hand_gflops_per_iter"] == cost_analysis.gan_iter_flops(B, dense) / 1e9
    assert line["hand_gflops_per_iter"] <= line["counted_gflops_per_iter"] <= xla
    assert line["critics_gflops"] > line["gen_update_gflops"] > 0
    assert line["mfu_counted"] == pytest.approx(
        line["counted_gflops_per_iter"] * 1e9 / 1e-3 / 67e12)


def test_graft_entry_forward_equals_the_jax_entry():
    """The port's generator forward with the JAX entry's weights (carried
    across by convert.load_generator) on the JAX entry's inputs: the same
    poses within 2e-4 m.  The two fp32 trunks, 1000 wide, sum in other
    orders: their heads differ by ~1.5e-5 on a scale of 24 (6e-7
    relative), which the angle scale (up to 180 degrees a unit of tanh) and
    the FK chains carry to ~1e-4 m on poses that reach 11 m (10 tanh for
    the root)."""
    import __graft_entry__ as jax_entry
    from dhaug_torch.models.convert import load_generator
    j_fn, j_args = jax_entry.entry()
    want = np.asarray(j_fn(*j_args))
    fn, (net, noise, bone_len, scaler8) = graft_entry.entry("cpu")
    assert noise.shape == (256, 128) and bone_len.shape == (256, 15) and scaler8.shape == (256, 8)
    load_generator(net, j_args[0])
    with torch.no_grad():
        got = fn(net, *[torch.as_tensor(np.array(a)) for a in j_args[1:]])
    assert got.shape == (256, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_graft_entry_dryrun_on_two_gloo_ranks():
    out = graft_entry.dryrun_multichip(2)
    assert out["max_rel_delta"] <= graft_entry.DRYRUN_TOL
    assert set(out["grid"]) == {"3d_wasserstein", "2d_wasserstein", "g_cost", "pos_loss",
                                "video_w3d", "video_motion_w2d", "video_g_cost"}


def test_fk_grad_ab_arms_agree_on_the_cpu():
    """Both arms run the plain FK on the CPU, so their epochs match exactly
    and no kernel launches."""
    out = bench_fk_grad_ab.main(["--device", "cpu", "--iters", "1", "--scan", "5",
                                 "--batch", "16", "--dense", "16"])
    assert out["w3d_max_abs_diff"] == 0.0
    assert out["launches_per_epoch"] == {"plain_grad": {"fwd": 0, "bwd": 0},
                                         "kernel_grad": {"fwd": 0, "bwd": 0}}
    assert out["plain_grad_ms_per_iter"] > 0 and out["kernel_grad_ms_per_iter"] > 0


def test_plain_fk_gradient_routes_only_the_gradient_path():
    from dhaug_torch.ops import fk_cuda
    calls = []
    kernel_route = fk_cuda.fk_world_pose_16
    fk_cuda.fk_world_pose_16 = lambda *a: calls.append("kernel") or kernel_route(*a)
    try:
        x = [torch.zeros(2, n) for n in (33, 15, 3, 3)]
        with bench_fk_grad_ab.plain_fk_gradient():
            fk_cuda.fk_world_pose_16(*x)
            fk_cuda.fk_world_pose_16(x[0].requires_grad_(True), *x[1:])
    finally:
        fk_cuda.fk_world_pose_16 = kernel_route
    assert calls == ["kernel"]


def test_components_run_on_the_cpu():
    lines = bench_components.main(["--device", "cpu", "--fk_batch", "64",
                                   "--synth_batches", "32,64", "--dense", "16",
                                   "--gan_batch", "16", "--iters", "1", "--pipelined", "5"])
    assert [line["component"] for line in lines] == ["fk", "synthesis", "synthesis",
                                                     "gan_steps"]
    assert all(v > 0 for line in lines for v in line.values() if isinstance(v, float))


def test_chip_smoke_bench_phase_launch_counts():
    """chip_smoke's bench phase expects exactly bench_launches() of B1, B2
    and B3 at three row counts: rehearsed here with stand-ins that count
    and run the plain FK and trunk, at tiny widths and batches with the
    phase's repeats."""
    import chip_smoke
    from dhaug_torch.models import trunk_cuda
    from dhaug_torch.ops import fk as fk_plain
    from dhaug_torch.ops import fk_cuda
    from dhaug_torch.parallel import sharded

    def forward(*x):
        fk_cuda.FWD_LAUNCHES += 1
        return fk_plain.fk_world_pose_16(*x)

    def route(*x):
        if torch.is_grad_enabled() and any(t.requires_grad for t in x):
            fk_cuda.FWD_LAUNCHES += 1
            fk_cuda.BWD_LAUNCHES += 1
            return fk_plain.fk_world_pose_16(*x)
        return fk_cuda.fk_forward_cuda(*x)

    def trunk(ops, noise):
        trunk_cuda.TRUNK_LAUNCHES += 1
        return trunk_cuda.trunk_reference_bf16(ops, noise)

    saved = fk_cuda.fk_forward_cuda, fk_cuda.fk_world_pose_16, sharded.trunk_forward
    fk_cuda.fk_forward_cuda, fk_cuda.fk_world_pose_16, sharded.trunk_forward = \
        forward, route, trunk
    out = io.StringIO()
    try:
        with chip_smoke.B1Rows(fk_cuda) as rows, contextlib.redirect_stdout(out):
            chip_smoke.reset_counts(fk_cuda, trunk_cuda)
            bench.main(["--device", "cpu", "--batch", "16", "--dense", "16", "--gan_batch", "8",
                        "--video_batch", "2"] + chip_smoke.BENCH_ARGV)
            launches = chip_smoke.read_counts(fk_cuda, trunk_cuda)
    finally:
        fk_cuda.fk_forward_cuda, fk_cuda.fk_world_pose_16, sharded.trunk_forward = saved
    assert launches == chip_smoke.bench_launches() == {"fwd": 100, "bwd": 14, "trunk": 24}
    assert sorted(set(rows)) == [8, 16, 18]   # GAN batch, video 2 x 9, synthesis batch
    assert len(out.getvalue().splitlines()) == 3
