"""Checkpoints and resume in the port (dhaug_torch/utils/checkpoint.py and
``run_fk_gan``'s best-posenet saves, snapshots and ``--resume``) on the
CPU.  A stopped-and-resumed run must equal the uninterrupted one bit for
bit: every parameter, buffer and optimizer state under ``torch.equal``."""
import os

import numpy as np
import pytest
import torch

from dhaug_torch import run_fk_gan
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
from dhaug_torch.utils.checkpoint import (load_ckpt, load_snapshot, restore_into,
                                          save_snapshot)
from dhaug_torch.utils.log import Summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the TINY widths of tests/test_torch_cli.py, 3 epochs, a snapshot every 2
RUN = ["--posenet_name", "mlp", "--lr_p", "1e-3", "--keypoints", "gt",
       "--batch_size", "512", "--data_enhancement_method", "GAN",
       "--single_or_multi_train_mode", "single", "--epochs", "3", "--snapshot", "2",
       "--additional_train_epoch", "0", "--warmup", "0", "--stages", "1",
       "--Gen_DenseDim", "32", "--Dis_DenseDim_3D", "32", "--Dis_DenseDim_2D", "32",
       "--data_root", REPO, "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These runs are too small to gain from torch's intra-op threads, and
    under a parallel test run those threads oversubscribe the cores and
    slow every process on them; the setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(result) -> dict:
    """Every parameter, buffer and optimizer-state tensor of a run."""
    gan = result["gan"]
    out = {}
    for name, net, opt in (("pos", result["posenet"], result["pos_opt"]),
                           ("gen", gan.gen, gan.gen_opt), ("d3d", gan.d3d, gan.d3d_opt),
                           ("d2d", gan.d2d, gan.d2d_opt)):
        out.update({f"{name}/{k}": v for k, v in net.state_dict().items()})
        opt_state = opt.state_dict()
        for i, state in opt_state["state"].items():
            out.update({f"{name}/opt/{i}/{k}": v for k, v in state.items()})
        out[f"{name}/opt/lr"] = torch.tensor([g["lr"] for g in opt_state["param_groups"]])
    out["torch_rng"] = result["generator"].get_state()
    return out


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    """The uninterrupted run: 3 epochs, snapshot after epoch 1."""
    return run_fk_gan.main(RUN + ["--checkpoint", str(tmp_path_factory.mktemp("a"))])


def test_stop_and_resume_is_bit_identical(run_a, tmp_path):
    a = run_a
    snapshot = os.path.join(a["run_dir"], "ckpt_resume_latest.ckpt")
    saved = load_snapshot(snapshot)
    assert saved["epoch"] == 1  # (epoch + 1) % 2 == 0 after epoch 1 only
    assert {"pos_state", "gen_state", "d3d_state", "d2d_state", "summary", "np_rng",
            "torch_rng", "lr_now", "dhpp1_best", "s911p1_best"} <= set(saved)
    for suffix in ("best_dhp_p1", "best_h36m_p1"):
        best = load_ckpt(os.path.join(a["run_dir"], f"ckpt_{suffix}.ckpt"))
        assert set(best) == {"epoch", "model_pos", "posenet_name"}
        assert best["posenet_name"] == "mlp" and "batch_norm1.running_var" in best["model_pos"]

    b = run_fk_gan.main(RUN + ["--checkpoint", str(tmp_path / "b"), "--resume", snapshot])
    assert len(b["epoch_seconds"]) == 1  # only epoch 2 ran
    assert b["scores"] == a["scores"]
    assert b["epoch_scalars"] == a["epoch_scalars"]
    ta, tb = _tensors(a), _tensors(b)
    assert list(ta) == list(tb)
    unequal = [k for k in ta if not torch.equal(ta[k], tb[k])]
    assert unequal == []


def test_resume_on_the_other_device_type_reseeds_the_generator(run_a, tmp_path, capsys):
    """A snapshot written on the card resumes on the CPU: weights, optimizer
    states and the numpy stream carry over; the torch.Generator stream,
    whose state format is the card's, is reseeded and the run says so."""
    saved = load_snapshot(os.path.join(run_a["run_dir"], "ckpt_resume_latest.ckpt"))
    saved["torch_rng"] = {"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
    path = save_snapshot(saved, str(tmp_path), suffix="resume_latest")
    c = run_fk_gan.main(RUN + ["--checkpoint", str(tmp_path / "c"), "--resume", path])
    assert "torch.Generator stream is for cuda; reseeded for cpu" in capsys.readouterr().out
    assert len(c["epoch_seconds"]) == 1
    assert all(np.isfinite(v) and v > 0 for v in c["scores"]["h36m"].values())
    assert not torch.equal(c["generator"].get_state(), run_a["generator"].get_state())


@pytest.mark.parametrize("change,message", [
    ("width", "shape mismatch at prelude.fc.weight"),
    ("drop", "structure mismatch"),
    ("rename", "key-path mismatch"),
])
def test_restore_into_raises_on_another_architecture(change, message):
    saved = FkGeneratorNet(GeneratorConfig(dense_dim=32)).state_dict()
    target = FkGeneratorNet(GeneratorConfig(dense_dim=40 if change == "width" else 32))
    if change == "drop":
        saved.pop("head.bias")
    elif change == "rename":
        saved = {k.replace("head.", "out."): v for k, v in saved.items()}
    with pytest.raises(ValueError, match=message):
        restore_into(target, saved)


def test_snapshot_round_trip_keeps_rng_states(tmp_path):
    np_rng = np.random.default_rng(123)
    np_rng.integers(0, 10, 5)
    gen = torch.Generator()
    gen.manual_seed(7)
    torch.rand(3, generator=gen)
    path = save_snapshot({"epoch": 4, "np_rng": np_rng.bit_generator.state,
                          "torch_rng": {"device": "cpu", "state": gen.get_state()},
                          "summary": {"epoch": 4}, "best": None, "lr": 0.5},
                         str(tmp_path), suffix="resume_latest")
    assert path.endswith("ckpt_resume_latest.ckpt")
    saved = load_snapshot(path)
    restored = np.random.default_rng()
    restored.bit_generator.state = saved["np_rng"]  # 128-bit ints survive
    assert np.array_equal(restored.integers(0, 1 << 30, 8), np_rng.integers(0, 1 << 30, 8))
    gen2 = torch.Generator()
    gen2.set_state(saved["torch_rng"]["state"])
    assert torch.equal(torch.rand(4, generator=gen2), torch.rand(4, generator=gen))
    assert (saved["epoch"], saved["best"], saved["lr"]) == (4, None, 0.5)


def test_orbax_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        save_snapshot({"epoch": 0}, str(tmp_path), suffix="x", fmt="orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        load_snapshot(str(tmp_path))
    with pytest.raises(ValueError, match="ckpt_format"):
        save_snapshot({"epoch": 0}, str(tmp_path), suffix="x", fmt="msgpack")


def test_summary_state_dict_round_trip(tmp_path):
    s = Summary(str(tmp_path))
    s.epoch, s.train_iter_num, s.train_fakepose_iter_num, s.train_discrim_iter_num = 3, 27, 5, 27
    s.record_epoch_scalars({"3d_wasserstein": 0.25, "g_cost": -1.5})
    t = Summary(str(tmp_path))
    t.load_state_dict(s.state_dict())
    assert t.state_dict() == s.state_dict()
    with pytest.raises(ValueError, match="unknown summary counter"):
        t.load_state_dict({"phase": 1})
