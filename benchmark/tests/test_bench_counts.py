"""The frozen algorithmic counts: at full shapes they equal the numbers
recorded in ``benchmark/counts/frozen.json``; at small shapes each is at
most what ``torch.utils.flop_counter.FlopCounterMode`` counts of the
port's own steps, so no count claims work the program does not do."""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.counts import flops
from benchmark.tests.tiny import tiny_spec

FROZEN = json.loads((harness.BENCH / "counts" / "frozen.json").read_text())


def _full(cell):
    spec = harness.cell_spec(cell)
    return spec.config, spec.traffic


def test_full_shape_counts_are_frozen():
    c, t = _full("video-train")
    assert flops.video_iteration(c, t) == pytest.approx(FROZEN["video-train"], rel=1e-12)
    c, t = _full("single-synth")
    assert flops.trunk(c["gan"]["gen_dense"], t["batch"]) == \
        pytest.approx(FROZEN["single-synth"]["b3"], rel=1e-12)
    assert flops.fk_forward(t["batch"]) == pytest.approx(FROZEN["single-synth"]["b1"],
                                                         rel=1e-12)


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def _iteration_counts(spec):
    """The port's FlopCounterMode count of one video GAN iteration
    (critics, and a fifth of a generator update) and of one posenet step."""
    from dhaug_torch.data.chunked import ChunkWindows
    from dhaug_torch.gan.video import build_video_gan
    from dhaug_torch.gan.wgan import camera_bank, tiled_cam16
    from dhaug_torch.models.factory import make_posenet
    from dhaug_torch.train.config import parse_aug_args
    from dhaug_torch.train.posenet import train_step
    from dhaug_torch.train.state import adam_posenet

    torch.manual_seed(0)
    args = parse_aug_args(spec.config["argv"])
    B = spec.traffic["batch"]
    g = torch.Generator().manual_seed(1)
    subjects = spec.config["train_subjects"]
    q, t, i = camera_bank(subjects[:1])
    cam16 = tiled_cam16(i[0], q[0], t[0], B)
    rng = np.random.default_rng(0)
    F = 9
    gan = build_video_gan(args, subjects, F, "cpu")
    loader = ChunkWindows(B, [cam16[0].numpy()], [rng.normal(0, .3, (B, 16, 3))
                                                  .astype(np.float32) + [0, 0, 5]],
                          [rng.normal(0, .3, (B, 16, 2)).astype(np.float32)], pad=4,
                          full_3d_window=True)
    cams, w3d, w2d = next(loader.device_epoch("cpu"))
    out = {}
    critics = _counted(lambda: out.setdefault("c", gan.critics_step(w3d, cams, w2d, g, True)))
    _, bone_len, *_ = out["c"]
    gen = _counted(lambda: gan.generator_step(bone_len, out["c"][0], g, True))
    net = make_posenet(args.posenet_name, flag="train", stages=args.stages,
                       dropout=args.dropout, architecture=args.architecture)
    x, y = torch.randn(B, F, 16, 2), torch.randn(B, 1, 16, 3)
    opt = adam_posenet(net.parameters())
    step = _counted(lambda: train_step(net, opt, x, y, 1.0, g, "mpjpe"))
    return critics + gen / 5, step


def test_training_count_is_at_most_the_ports():
    spec = tiny_spec("video-train")
    gan_counted, step_counted = _iteration_counts(spec)
    ours = flops.video_iteration(spec.config, spec.traffic)
    assert 0 < ours["gan"] <= gan_counted
    assert 0 < ours["posenet"] <= 8 * step_counted
    # the count is the algorithm's, not a token fraction of the port's
    assert ours["gan"] >= 0.5 * gan_counted


def test_trunk_count_is_at_most_the_ports():
    from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
    from dhaug_torch.models.trunk_cuda import trunk_reference_bf16, trunk_weights

    for d, rows in ((64, 32), (1000, 8)):
        ops = trunk_weights(FkGeneratorNet(GeneratorConfig(dense_dim=d)))
        counted = _counted(lambda: trunk_reference_bf16(ops, torch.randn(rows, 128)))
        ours = flops.trunk(d, rows)["flop"]
        assert ours <= counted and ours >= 0.9 * counted * (d / (-(-d // 64) * 64)) ** 2


def test_fk_count_matches_the_published_equations():
    assert flops.FK_FLOP_PER_POSE == 33 * 8 + 30 * 63 + 27 + 16 * 18
    assert flops.fk_forward(1)["bytes"] == 4 * (33 + 15 + 3 + 3 + 48)
    assert math.isclose(flops.fk_forward(65536)["bytes"] / 3.35e12 * 1e6, 7.98, rel_tol=1e-2)
