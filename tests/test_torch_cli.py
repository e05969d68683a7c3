"""The slice as a whole: ``python -m dhaug_torch.run_fk_gan`` on the CPU at
tiny widths on the repo's fixtures, the package's independence from JAX, and
the flags it refuses."""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--posenet_name", "mlp", "--lr_p", "1e-3", "--keypoints", "gt",
        "--batch_size", "512", "--data_enhancement_method", "GAN",
        "--single_or_multi_train_mode", "single", "--epochs", "2",
        "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
        "--Gen_DenseDim", "32", "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32",
        "--data_root", REPO]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_two_epoch_cpu_run_writes_the_jax_log_schema(tmp_path):
    code = (
        "import json, sys\n"
        "from dhaug_torch import run_fk_gan\n"
        "from dhaug_torch.ops import fk_cuda\n"
        "out = run_fk_gan.main(sys.argv[1:])\n"
        "print(json.dumps({'launches': [fk_cuda.FWD_LAUNCHES, fk_cuda.BWD_LAUNCHES],\n"
        "                  'run_dir': out['run_dir'], 'scores': out['scores'],\n"
        "                  'scalars': out['epoch_scalars']}))\n")
    proc = subprocess.run([sys.executable, "-c", code, *TINY, "--device", "cpu",
                           "--checkpoint", str(tmp_path)],
                          capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["launches"] == [0, 0]  # the CPU never reaches the kernels
    for scores in result["scores"].values():
        assert all(np.isfinite(v) and v > 0 for v in scores.values())
    assert len(result["scalars"]["3d_wasserstein"]) == 2

    log = open(os.path.join(result["run_dir"], "log.txt")).read().splitlines()
    header = log.index("epoch\tlr\terror_h36m_p1\terror_h36m_p2\terror_3dhp_p1\t"
                       "error_3dhp_p2\tPCK\tAUC")
    # data rows; "==> Saving checkpoint ..." lines record the best saves
    rows = [line.split("\t") for line in log[header + 1:] if not line.startswith("==>")]
    # epoch 0 (warmup 0 -> no posenet pass yet), epoch 1 '_fake' + final rows
    assert [r[0] for r in rows] == ["0", "1", "1"]
    assert any(line.startswith("==> Saving checkpoint at epoch '1'") for line in log)
    assert all(len(r) == 8 for r in rows)
    assert all(np.isfinite(float(v)) for v in rows[-1])
    assert float(rows[-1][2]) > 0
    metrics = open(os.path.join(result["run_dir"], "metrics.jsonl")).read()
    assert "train_G_iter_PoseFk/Fk_d3d_Wasserstein_D" in metrics
    assert "posenet_mpi3d_loader_flip/p1score_real" in metrics


def test_no_jax_in_the_port():
    """Importing every dhaug_torch module (and chip_smoke.py) loads no jax,
    flax, optax or dhaug_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dhaug_torch\n"
        "for m in pkgutil.walk_packages(dhaug_torch.__path__, 'dhaug_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'dhaug_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('dhaug_torch.')]), bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=_env(), cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules, bad = proc.stdout.strip().splitlines()[-1].split(" ", 1)
    assert bad == "[]"
    assert int(n_modules) >= 36


def test_device_cuda_without_a_card_raises():
    import torch

    from dhaug_torch import run_fk_gan
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fk_gan.main(TINY + ["--device", "cuda"])


@pytest.mark.parametrize("flags", [
    ["--data_enhancement_method", "normal"],
    ["--data_enhancement_method", "NO_enhance"],
    ["--single_or_multi_train_mode", "multi"],
    ["--posenet_name", "videopose"],
    ["--ckpt_format", "orbax"],
    ["--evaluate", "x.ckpt"],
    ["--record_all_picture", "true"],
    ["--data_parallel_devices", "2"],
])
def test_unported_flags_are_refused(flags):
    from dhaug_torch import run_fk_gan
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run_fk_gan.main(TINY + ["--device", "cpu"] + flags)


def test_parser_keeps_every_reference_flag_and_default():
    from dhaug_torch.train.config import get_aug_parser as torch_parser
    from dhaug_tpu.train.config import get_aug_parser as jax_parser

    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    t, j = flags(torch_parser()), flags(jax_parser())
    assert set(j) - set(t) == {"jax_platform"}
    assert set(t) - set(j) == {"device"}
    assert t["device"] == "cuda"
    assert {k: v for k, v in t.items() if k != "device"} == \
        {k: v for k, v in j.items() if k != "jax_platform"}


@pytest.mark.parametrize("extra", [[], ["--downsample", "3", "--actions", "Walking"]])
def test_prepare_data_matches_jax(extra):
    from dhaug_torch.train.config import parse_aug_args as torch_args
    from dhaug_torch.train.data_prep import prepare_data as torch_prepare
    from dhaug_tpu.train.config import parse_aug_args as jax_args
    from dhaug_tpu.train.data_prep import prepare_data as jax_prepare

    argv = ["--data_root", REPO] + extra
    t, j = torch_prepare(torch_args(argv)), jax_prepare(jax_args(argv))
    for name in ("train_det2d3d", "train_gt2d3d", "h36m_test"):
        for field in ("poses_3d", "poses_2d", "cams"):
            np.testing.assert_array_equal(getattr(getattr(t, name), field),
                                          getattr(getattr(j, name), field),
                                          err_msg=f"{name}.{field}")
    np.testing.assert_array_equal(t.mpi3d.poses_3d, j.mpi3d.poses_3d)
    np.testing.assert_array_equal(t.mpi3d.poses_2d, j.mpi3d.poses_2d)
