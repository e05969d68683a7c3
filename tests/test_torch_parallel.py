"""Data parallelism in the port (dhaug_torch/parallel/mesh.py and the
modules that take a rank's rows) on the CPU: two gloo ranks, each a spawned
process, against one process and against the JAX package's 2-device mesh.

The ranks run the worker functions of tests/test_torch_dp_worker.py, which
this process also runs alone for the one-device side.  Bounds:

* one critic phase and one generator update with SGD and injected draws:
  the updated weights within 1e-6 (critics) and 1e-5 (generator), the bounds
  the port meets against JAX on one device (tests/test_torch_gan.py); fakes
  and scalars within 1e-6, relative for the gradient penalty, which reaches
  ~1e8 on fresh critics.  Against the JAX package on a 2-device mesh the
  weights keep those bounds and the fakes and scalars the cross-package
  ones of tests/test_torch_gan.py (1e-5; rtol 1e-4);
* a whole GAN epoch with Adam: the JAX package's own sharded-vs-single
  bounds (tests/test_parallel.py:175-187): weights rtol 1e-3 / atol 5e-4,
  the Wasserstein trajectory and the fake buffers 1e-4, and the two ranks'
  weights bit-identical; in video mode the weight elements whose gradient
  is zero to rounding, and the iteration after the generator's update, are
  set apart by the rules the test states;
* a posenet epoch with batch norm and dropout: those of
  tests/test_parallel.py:324-333, mean loss rtol 1e-4 and predictions atol
  5e-3, and the batch-norm statistics of a global batch within 1e-6;
* evaluation: P1/P2 within 1e-4 mm, PCK/AUC within 1e-4 %.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dp_worker as worker
from dhaug_torch.gan.wgan import camera_bank
from dhaug_torch.parallel import mesh
from test_torch_gan import (CRITIC_LR, GEN_LR, SUBJECTS, W, Pair, _assert_delta, _batch, _draws,
                            _jax_draws, _real_poses)
from test_torch_video import _clips

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The ranks run one intra-op thread each (``launch(threads=1)``), and
    so does this process: under a parallel test run more threads
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("MKL_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


def two_ranks(fn, *args):
    return mesh.launch(f"test_torch_dp_worker:{fn}", args, RANKS, "gloo", threads=1)


def _sds(*modules):
    return [{k: v.numpy() for k, v in m.state_dict().items()} for m in modules]


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


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
    one = worker.gan_step_phases(*args)
    ranks = two_ranks("gan_step_phases", *args)
    return critics, gens, batch, draws, gen_inputs, one, ranks


def test_two_ranks_equal_one_process_step_by_step(steps_case):
    *_, one, ranks = steps_case
    for r in ranks:
        for net, tol in (("d3d", 1e-6), ("d2d", 1e-6), ("gen", 1e-5)):
            for k, v in one[net].items():
                _close(r[net][k], v, tol, what=f"{net}.{k}")
        for k in ("bone_len", "fake3d", "fake2d", "intr"):
            _close(r[k], one[k], 1e-6, what=k)
        for k, v in one["metrics"].items():
            _close(r["metrics"][k], v, 1e-6, 1e-6, what=k)
        _close(r["g_cost"], one["g_cost"], 1e-6, 1e-6, what="g_cost")
        assert r["cam_idx"] == one["cam_idx"]
        # each rank's rows of the FK of a global batch
        _close(r["fk_rows"], one["fk_rows"], 1e-6, what="fk_rows")
    # the ranks applied the same update
    for net in ("d3d", "d2d", "gen"):
        assert all(np.array_equal(ranks[0][net][k], ranks[1][net][k]) for k in one[net])


def test_two_ranks_equal_the_jax_package_on_a_2_device_mesh(steps_case):
    """The port's 2-rank steps against the JAX steps on a 2-device virtual
    CPU mesh, the inputs placed by ``shard_batch`` and the states
    replicated (as tests/test_parallel.py:488-540 places them)."""
    from dhaug_torch.models import convert
    from dhaug_torch.models import discriminators as t_disc
    from dhaug_torch.models import generator as t_gen
    from dhaug_tpu.parallel.mesh import make_mesh, replicate, shard_batch

    critics, gens, batch, draws, gen_inputs, _, ranks = steps_case
    m = make_mesh(2)
    with m:
        real, cam16, tgt2d = shard_batch(m, *(jnp.asarray(x) for x in batch))
        d3d_s, d2d_s, _, _, f3d, f2d, _, m_j = critics.j.critics_step(
            replicate(m, critics.d3d_s), replicate(m, critics.d2d_s),
            replicate(m, critics.gen_s.params), real, cam16, tgt2d, jax.random.PRNGKey(9),
            **_jax_draws(draws))
        gen_s, gm = gens.j.generator_step(
            replicate(m, gens.gen_s), replicate(m, gens.p3), replicate(m, gens.p2),
            shard_batch(m, jnp.asarray(gen_inputs["bone_len"])),
            jnp.asarray(gen_inputs["cam_idx"], jnp.int32), jax.random.PRNGKey(3),
            noise=jnp.asarray(gen_inputs["noise"]), scaler8=jnp.asarray(gen_inputs["scaler8"]))
    r = ranks[0]
    load = worker.load_state
    _assert_delta(convert.load_d3d, load(t_disc.Fk3DDiscriminator(W), r["d3d"]), critics.p3,
                  d3d_s.params, 1e-6, "d3d")
    _assert_delta(convert.load_d2d, load(t_disc.Fk2DDiscriminator(W), r["d2d"]), critics.p2,
                  d2d_s.params, 1e-6, "d2d")
    _assert_delta(convert.load_generator,
                  load(t_gen.FkGeneratorNet(t_gen.GeneratorConfig(dense_dim=W)), r["gen"]),
                  gens.gp, gen_s.params, 1e-5, "generator")
    _close(r["fake3d"], np.asarray(f3d), 1e-5, what="fake3d")
    _close(r["fake2d"], np.asarray(f2d), 1e-5, what="fake2d")
    for k, v in m_j.items():
        _close(r["metrics"][k], float(v), 1e-5, 1e-4, what=k)
    _close(r["g_cost"], float(gm["g_cost"]), 1e-6, 1e-5, what="g_cost")


def test_two_ranks_equal_one_process_step_by_step_in_video_mode():
    """The video steps (motion critics and playback on, tests/test_torch_
    video.py's SGD rates and draws): the critics' and the generator's
    updates within 1e-6 and 1e-5, on 2 ranks of 3 clips each.  The fake
    clips reach ~20 m in camera space (fp32 ulp 1.9e-6 m) and come from the
    generator's trunk on 3 rows instead of 6, a different summation order:
    measured 1.3e-5 m (3D) and 2.8e-5 (normalized 2D), held to 5e-5.  The
    critics' scalars of those fakes keep tests/test_torch_video.py's bound,
    1e-4 of the larger of the value and 1 (the motion-3D critic's large
    input gradients carry the fakes' differences into its scores)."""
    from test_torch_video import (CRITIC_2D_LR, CRITIC_3D_LR, F, VideoPair)
    from test_torch_video import GEN_LR as VIDEO_GEN_LR
    from test_torch_video import _draws as video_draws
    pair = VideoPair(playback=True)
    rng = np.random.default_rng(11)
    batch = pair.batch(rng, cam_row=2)
    draws, gen_draws = video_draws(rng), video_draws(rng)
    lrs = (VIDEO_GEN_LR, CRITIC_3D_LR, CRITIC_2D_LR, CRITIC_3D_LR, CRITIC_2D_LR)
    args = (W, F, SUBJECTS, _sds(*pair.t_nets), lrs, batch, draws,
            {k: gen_draws[k] for k in ("noise", "scaler8")})
    one = worker.video_step_phases(*args)
    ranks = two_ranks("video_step_phases", *args)
    for r in ranks:
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
    for net in range(4):
        assert all(np.array_equal(ranks[0]["critics"][net][k], ranks[1]["critics"][net][k])
                   for k in one["critics"][net])


# ---------------------------------------------------------------------------
# whole GAN epochs
# ---------------------------------------------------------------------------

def _frames(n, seed):
    rng = np.random.default_rng(seed)
    quats, trans, intrs = (np.asarray(x) for x in camera_bank(SUBJECTS))
    rows = rng.integers(0, len(quats), n)
    cam16 = np.concatenate([intrs[rows], quats[rows], trans[rows]], axis=1).astype(np.float32)
    return (_real_poses(rng, n), (rng.normal(size=(n, 16, 2)) * 0.3).astype(np.float32),
            cam16)


def _sequences(seed, n=3, frames=6):
    rng = np.random.default_rng(seed)
    quats, trans, intrs = (np.asarray(x) for x in camera_bank(SUBJECTS))
    seq3d = [c for c in _clips(rng, n, frames=frames)]
    seq2d = [(rng.normal(size=(frames, 16, 2)) * 0.3).astype(np.float32) for _ in range(n)]
    cams = [np.concatenate([intrs[i], quats[i], trans[i]]).astype(np.float32) for i in range(n)]
    return seq3d, seq2d, cams


# a gradient element is zero to rounding when its largest magnitude over the
# epoch's steps is at most this share of the largest in its leaf: about the
# fp32 rounding bound of a sum over the ~100 rows that make each element,
# n * 2**-24 ~ 6e-6 of the terms' size
ROUNDING_SHARE = 1e-5


@pytest.mark.parametrize("mode", ["single", "video"])
def test_a_gan_epoch_on_two_ranks_equals_one_process(mode):
    """A whole epoch of six batches from global iteration 0, with Adam, as
    in tests/test_parallel.py:140-187: single-frame batches of 16 frames, or
    video batches of 8 clips of 3 frames (motion critics and playback on;
    8 sequences of 6 frames give 48 clips).  The generator updates at
    iteration 4.  Bounds of the JAX package's tests: weights rtol 1e-3 /
    atol 5e-4 (the generator in video mode atol 2e-4, its video test's
    bound, tests/test_parallel.py:411-414), the Wasserstein trajectory and
    the fake buffers 1e-4, the ranks' weights bit-identical.

    In video mode two things are set apart, each by a rule and shown:

    * weight elements whose gradient in the one-process run is zero to
      rounding (``ROUNDING_SHARE`` of their leaf's largest, over every step
      of the epoch, read by ``worker.GradientLog``).  Adam scales a step to
      ~lr whatever the gradient's size, so on such an element summation-
      order noise moves the two runs ~lr apart a step.  Measured: the two
      per-frame critics' output biases, whose gradient D(fake) - D(real)
      cancels to exactly 0 in one process but not on a rank's 12 rows,
      7.2e-4 apart; a motion-3D weight with gradient 2.5e-2 beside its
      leaf's 1.0e4 (2.4e-6 of it), 6.0e-4 apart.  Every other element is
      held to the bounds, and the excluded ones with a nonzero gradient
      must stay a small share of each net;
    * the fakes and estimates of the iteration after the generator's update
      (iteration 5).  The generator's first Adam step moves each weight by
      lr times the sign of its gradient, so a weight whose gradient's sign
      differs between the runs (the critics having drifted as above) ends
      2 lr apart (the bound checks it), and the fakes of that generator
      came 8.9e-3 m apart (3D) and the estimates up to 5.4e-4.  The JAX
      package's video test holds only fakes of the initial generator
      (tests/test_parallel.py:381-384), and so do these bounds; iteration
      5 is checked for shape and finiteness."""
    if mode == "single":
        args = ("single", W, 1, SUBJECTS, _frames(100, 3), 16, 5)
    else:
        args = ("video", W, 3, SUBJECTS, _sequences(4, n=8), 8, 5)
    one = worker.gan_epoch(*args)
    ranks = two_ranks("gan_epoch", *args)
    check_gan_epoch(mode, one, ranks)


def check_gan_epoch(mode, one, ranks):
    """The bounds of :func:`test_a_gan_epoch_on_two_ranks_equals_one_process`
    on every rank's epoch (each rank's weights in the single-device
    layout) against the one-process epoch ``one``."""
    for a in ranks[1:]:
        for x, y in zip(ranks[0]["nets"], a["nets"]):
            assert all(np.array_equal(x[k], y[k]) for k in x), "the ranks' weights differ"
    r = ranks[0]
    for net, (want, got, grads) in enumerate(zip(one["nets"], r["nets"], one["grad_max_abs"])):
        atol = 2e-4 if mode == "video" and net == 0 else 5e-4
        set_apart, size, widest = 0, 0, (0.0, "")
        for k, v in want.items():
            held = np.ones(v.shape, bool)
            if mode == "video" and k in grads:
                g = grads[k]
                held = g > ROUNDING_SHARE * g.max()
                set_apart += int(((~held) & (g > 0)).sum())
                size += g.size
                gap = np.where(held, -1.0, np.abs(got[k] - v))
                i = np.argmax(gap)
                widest = max(widest, (float(gap.flat[i]), f"{k}: gradient {g.flat[i]:.2e} "
                                                          f"beside the leaf's {g.max():.2e}"))
            _close(got[k][held], v[held], atol, 1e-3, what=k)
        if mode == "video":
            print(f"net {net}: {set_apart} of {size} elements with a nonzero gradient set "
                  f"apart; the widest {widest[0]:.2e} apart, {widest[1]}")
            assert set_apart <= 0.05 * size, (net, set_apart, size)
    wtags = [t for t in one["scalars"] if "Wasserstein" in t]
    assert len(wtags) >= 2 and set(r["scalars"]) == set(one["scalars"])
    held_iters = 6 if mode == "single" else 5
    for t in wtags:
        steps = sorted(one["scalars"][t])
        assert steps == list(range(6)) and sorted(r["scalars"][t]) == steps
        got = [r["scalars"][t][s] for s in steps]
        assert np.all(np.isfinite(got))
        _close(got[:held_iters], [one["scalars"][t][s] for s in steps[:held_iters]],
               1e-4, 1e-4, what=t)
    rows = (len(one["fakes"][0]) // 6) * held_iters
    for got, want in zip(r["fakes"], one["fakes"]):
        assert got.shape == want.shape and np.all(np.isfinite(got))
        _close(got[:rows], want[:rows], 1e-4, 1e-4, what="fake buffer")


# ---------------------------------------------------------------------------
# posenet epochs and evaluation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def posenet_case():
    """tests/test_parallel.py:292-333's data (80 frames, batch 16); an
    evaluation set of 101 frames, whose last batch of 16 holds 5; three
    sequences, 102 windows of 9 frames."""
    rng = np.random.default_rng(6)
    frames = lambda n, d: (rng.normal(size=(n, 16, d)) * 0.3).astype(np.float32)
    train_set = (frames(80, 2), frames(80, 3), frames(8, 2))
    eval_set = (frames(101, 2), frames(101, 3))
    lengths = (40, 29, 33)
    windows = ([frames(m, 3) for m in lengths], [frames(m, 2) for m in lengths])
    args = (train_set, eval_set, windows, 16, 7, (16, 12, 7))
    return worker.posenet_epochs(*args), two_ranks("posenet_epochs", *args)


def test_a_posenet_epoch_with_batch_norm_and_dropout_on_two_ranks(posenet_case):
    one, ranks = posenet_case
    for net in ("mlp", "video"):
        assert all(np.array_equal(ranks[0][net][k], ranks[1][net][k]) for k in one[net])
    r = ranks[0]
    for k, v in one["bn_first_batch"].items():
        _close(r["bn_first_batch"][k], v, 1e-6, what=k)
    for k in ("mlp_loss", "video_loss"):
        _close(r[k], one[k], 0.0, 1e-4, what=k)
    for k in ("mlp_pred", "video_pred"):
        _close(r[k], one[k], 5e-3, what=k)
    assert one["mlp"]["linear_stages.0.batch_norm1.num_batches_tracked"] == \
        r["mlp"]["linear_stages.0.batch_norm1.num_batches_tracked"]


def test_the_normal_mode_augmenter_runs_whole_on_every_rank():
    """``--data_enhancement_method normal``: each rank draws the whole
    random-FK set from the same generator (no sharding, as in the JAX
    package), so its fakes equal the one-process set bit for bit; the
    posenet pass over them takes each rank's rows (loss rtol 1e-4, as the
    posenet epoch test)."""
    pool = _real_poses(np.random.default_rng(8), 64)
    args = (pool, SUBJECTS, 40, 16, 9)
    one = worker.traditional_epoch(*args)
    ranks = two_ranks("traditional_epoch", *args)
    for r in ranks:
        for got, want in zip(r["fakes"], one["fakes"]):
            assert np.array_equal(got, want)
        _close(r["loss"], one["loss"], 0.0, 1e-4, what="loss")
    assert all(np.array_equal(ranks[0]["mlp"][k], ranks[1]["mlp"][k]) for k in one["mlp"])


def test_evaluation_on_two_ranks_sums_to_the_one_device_scores(posenet_case):
    """Batches of 16, 12 and 7 shard over the ranks (the last of 16, of 5
    frames, and every batch of 7 edge-padded); windows of the VideoPose's
    set too."""
    one, ranks = posenet_case
    cases = [(one["mlp_eval"][k], ranks[0]["mlp_eval"][k]) for k in one["mlp_eval"]]
    cases.append((one["video_eval"], ranks[0]["video_eval"]))
    for want, got in cases:
        for k in ("p1", "p2", "pck", "auc"):
            _close(got[k], want[k], 1e-4, what=k)
    assert ranks[0]["mlp_eval"] == ranks[1]["mlp_eval"]


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def test_multi_process_synthesis_writes_the_in_process_concatenation(tmp_path):
    from dhaug_torch import synthesize_dataset
    from dhaug_torch.models import trunk_cuda
    from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
    from dhaug_torch.ops.fk import CANONICAL_BONE_LEN
    from dhaug_torch.parallel.sharded import make_sharded_synthesizer, stream

    out = tmp_path / "dh_synth.npz"
    port = mesh.free_port()
    flags = ["--device", "cpu", "--random_init", "true", "--Gen_DenseDim", "32",
             "--n_poses", "300", "--batch", "128", "--out", str(out),
             "--coordinator", f"localhost:{port}", "--num_processes", "2"]
    procs = [subprocess.Popen([sys.executable, "-m", "dhaug_torch.synthesize_dataset", *flags,
                               "--process_id", str(i)], env=_env(), cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    data = np.load(out)
    assert int(data["n_devices"]) == 2 and int(data["seed"]) == 0
    assert data["pose3d"].shape == (300, 16, 3)

    cfg = GeneratorConfig(dense_dim=32)
    torch.manual_seed(0)
    ops = trunk_cuda.trunk_weights(FkGeneratorNet(cfg).eval())
    synthesize = make_sharded_synthesizer(cfg, n_devices=2)
    cameras = camera_bank(list(synthesize_dataset.CAMERA_SUBJECTS))
    bone_len = torch.tensor(CANONICAL_BONE_LEN).expand(128, 15).contiguous()
    parts = []
    for i in range(3):
        cam_idx = torch.randint(0, cameras[0].shape[0], (), generator=stream("cpu", 1, i))
        parts.append(synthesize_dataset.synth_pairs(
            synthesize, ops, bone_len, cameras, [stream("cpu", 1, i, s) for s in range(2)],
            cam_idx=cam_idx))
    for j, key in enumerate(("pose3d", "pose2d", "cam")):
        want = torch.cat([p[j] for p in parts])[:300].numpy()
        _close(data[key], want, 1e-6, what=key)


TINY = ["--posenet_name", "mlp", "--lr_p", "1e-3", "--keypoints", "gt",
        "--batch_size", "512", "--data_enhancement_method", "GAN",
        "--single_or_multi_train_mode", "single", "--epochs", "2",
        "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
        "--Gen_DenseDim", "32", "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32",
        "--data_root", REPO, "--device", "cpu"]


def test_cli_trains_on_two_ranks_and_only_rank_0_writes(tmp_path):
    import json
    code = (
        "import json, sys\n"
        "from dhaug_torch import run_fk_gan\n"
        "out = run_fk_gan.main(sys.argv[1:])\n"
        "print(json.dumps({'ranks': out['rank_launches'], 'run_dir': out['run_dir'],\n"
        "                  'scores': out['scores'], 'scalars': out['epoch_scalars']}))\n")
    proc = subprocess.run([sys.executable, "-c", code, *TINY, "--data_parallel_devices", "2",
                           "--checkpoint", str(tmp_path)],
                          capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["ranks"] == [{"fwd": 0, "bwd": 0, "trunk": 0}] * 2   # the CPU: no kernel
    for scores in result["scores"].values():
        assert all(np.isfinite(v) and v > 0 for v in scores.values())
    assert len(result["scalars"]["3d_wasserstein"]) == 2
    run_dir = result["run_dir"]
    # one run directory, written once: each log row and scalar appears once
    assert [os.path.join(str(tmp_path), *p) for p in
            [("mlp", "gt", os.listdir(os.path.join(str(tmp_path), "mlp", "gt"))[0])]] == [run_dir]
    assert sorted(os.listdir(run_dir)) == ["ckpt_best_dhp_p1.ckpt", "ckpt_best_h36m_p1.ckpt",
                                           "ckpt_resume_latest.ckpt", "log.txt",
                                           "metrics.jsonl", "tmp"]
    log = open(os.path.join(run_dir, "log.txt")).read().splitlines()
    header = log.index("epoch\tlr\terror_h36m_p1\terror_h36m_p2\terror_3dhp_p1\t"
                       "error_3dhp_p2\tPCK\tAUC")
    rows = [line.split("\t") for line in log[header + 1:] if not line.startswith("==>")]
    assert [r[0] for r in rows] == ["0", "1", "1"]
    assert all(np.isfinite(float(v)) for v in rows[-1])
    lines = [json.loads(x) for x in open(os.path.join(run_dir, "metrics.jsonl"))]
    keys = [(x["tag"], x["step"]) for x in lines]
    assert len(keys) == len(set(keys))
    assert ("train_G_iter_PoseFk/Fk_d3d_Wasserstein_D", 0) in keys


def test_baseline_cli_trains_on_two_ranks_like_one_process(tmp_path):
    """``run_baseline --data_parallel_devices 2`` (the library launcher the
    CLI calls, gloo on the CPU) against one process: the MLP at lr 1e-4 as
    in tests/test_parallel.py:292-333, one epoch; rank 0 alone writes, and
    the best H36M/3DHP P1 stay within 0.05 mm (measured 0.005 mm), the
    bound chip_smoke.py holds run_evaluate to against a run's best."""
    from dhaug_torch import run_baseline
    base = ["--posenet_name", "mlp", "--stages", "1", "--batch_size", "512", "--lr", "1e-4",
            "--epochs", "1", "--data_root", REPO, "--device", "cpu"]
    one = run_baseline.main(base + ["--checkpoint", str(tmp_path / "one")])
    two = mesh.launch_main("dhaug_torch.run_baseline",
                           base + ["--checkpoint", str(tmp_path / "two"),
                                   "--data_parallel_devices", "2"], RANKS, "gloo", threads=1)
    assert two["rank_launches"] == [{"fwd": 0, "bwd": 0, "trunk": 0}] * 2
    assert sorted(os.listdir(two["run_dir"])) == sorted(os.listdir(one["run_dir"]))
    assert len(os.listdir(os.path.join(str(tmp_path), "two", "mlp", "gt"))) == 1
    for key in ("best_h36m", "best_dhp"):
        assert np.isfinite(two[key]) and abs(two[key] - one[key]) <= 0.05, (key, two, one)


@pytest.mark.parametrize("flags,error", [
    (["--data_parallel_devices", str((os.cpu_count() or 1) + 1)],
     r"requests \d+ devices but only \d+ device\(s\) are visible on platform 'cpu'"),
    (["--data_parallel_devices", "3"], "--batch_size 512 is not divisible by "
                                       "--data_parallel_devices 3"),
    (["--data_parallel_devices", "2", "--device", "cuda"],
     r"requests 2 devices but only \d+ device\(s\) are visible on platform 'cuda'"),
    (["--model_parallel_devices", str((os.cpu_count() or 1) + 1)],
     r"--data_parallel_devices 1 x --model_parallel_devices \d+ requests \d+ devices but "
     r"only \d+ device\(s\) are visible on platform 'cpu'"),
    (["--data_parallel_devices", "2", "--model_parallel_devices", "2", "--device", "cuda"],
     r"--data_parallel_devices 2 x --model_parallel_devices 2 requests 4 devices but only "
     r"\d+ device\(s\) are visible on platform 'cuda'"),
])
def test_cli_refuses_a_request_it_cannot_meet_before_any_work(flags, error, tmp_path):
    from dhaug_torch import run_fk_gan
    asked = 4 if "--model_parallel_devices" in flags else 2
    if "cuda" in flags and torch.cuda.device_count() >= asked:
        pytest.skip(f"{asked} cards are visible")
    with pytest.raises(SystemExit, match=error):
        run_fk_gan.main(TINY + flags + ["--checkpoint", str(tmp_path)])
    assert not os.listdir(tmp_path)
