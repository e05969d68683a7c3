"""The PoseFormer cell's own pieces: its frozen count, held at or under
what ``FlopCounterMode`` counts of the port's own step; its reference and
follow, which load nothing of the program; and its faults and control,
which the check that decides ``correct`` fails on the tiny cell
(``tiny_poseformer.py``: its limits, and its sound run, made once).

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import json
import math
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import checks, harness, pool
from benchmark.counts import poseformer
from benchmark.poseformer_faults import FAULTS
from benchmark.tests import tiny_poseformer as tiny

CELL = "video-train-poseformer"
FROZEN = json.loads((harness.BENCH / "counts" / "frozen_poseformer.json").read_text())[CELL]


def test_full_shape_count_is_frozen():
    spec = harness.cell_spec(CELL)
    count = poseformer.video_iteration(spec.config, spec.traffic)
    assert count == pytest.approx({k: FROZEN[k] for k in ("gan", "posenet", "total")},
                                  rel=1e-12)
    assert poseformer.train_step(spec.config["posenet"], spec.traffic["batch"]) == \
        pytest.approx(FROZEN["posenet_step"], rel=1e-12)


@pytest.mark.parametrize("widths,embed,depth,heads,clips", [
    ((3, 3), 8, 2, 2, 4), ((3, 3, 3), 32, 1, 8, 2), ((3, 3, 3, 3), 32, 4, 8, 2)])
def test_step_count_is_at_most_the_ports(widths, embed, depth, heads, clips):
    """One PoseFormer ``train_step`` of the port under ``FlopCounterMode``
    (every product: the dense layers, both attention products, the
    weighted mean's convolution, forward and backward) against the count,
    which leaves out no product of the step."""
    from dhaug_torch.models.posenets import PoseFormer
    from dhaug_torch.train.posenet import train_step
    from dhaug_torch.train.state import adam_posenet

    frames = math.prod(widths)
    net = PoseFormer(num_frame=frames, embed_dim_ratio=embed, depth=depth, num_heads=heads)
    x, y = torch.randn(clips, frames, 16, 2), torch.randn(clips, 1, 16, 3)
    opt = adam_posenet(net.parameters())
    with FlopCounterMode(display=False) as counter:
        train_step(net, opt, x, y, 1.0, torch.Generator().manual_seed(0), "mpjpe")
    counted = float(counter.get_total_flops())
    ours = poseformer.train_step({"filter_widths": list(widths), "embed_dim_ratio": embed,
                                  "depth": depth, "mlp_ratio": 2.0}, clips)
    assert 0.999 * counted <= ours <= counted


_LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.poseformer, benchmark.reference.follow_poseformer
import benchmark.counts.poseformer
print(json.dumps(sorted(sys.modules)))
"""


def test_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", _LOAD_REFERENCE.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, check=True, timeout=300)
    loaded = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "torch" in loaded
    assert not [m for m in loaded if m.startswith("dhaug")]
    assert not loaded & set(harness.FORBIDDEN)


@pytest.mark.parametrize("fault", ["spatial_block_skipped"])
def test_a_broken_poseformer_is_not_correct(fault, monkeypatch):
    """The tiny cell with a PoseFormer fault planted fails its check, on a
    number that reads ten times the sound run's or more."""
    sound = tiny.values(tiny.sound())
    cut = tiny.spec()
    FAULTS[fault](cut, monkeypatch.setattr)
    line = tiny.run(cut)
    broken = tiny.values(line)
    assert line["correct"] is False
    assert any(broken[k] > 10 * sound[k] for k in broken), (broken, sound)


def test_temporal_head_zeroed_puts_out_zeros_for_one_head(monkeypatch):
    """The fault ``temporal_head_zeroed``, which the card's check catches
    (``loss_gap`` 3.96e-3 to 4.5e-2 against a limit of 3e-3) and the tiny
    cell's cannot (2.5e-3 to 2.8e-2 on the posenet's losses, inside the
    spread of sound runs at 8 clips a batch): on a net built after it is
    planted, the last temporal block's projection takes zeros for its
    first head, and the output moves."""
    from dhaug_torch.models.posenets import PoseFormer

    make = lambda: PoseFormer(num_frame=9, embed_dim_ratio=8, depth=2, num_heads=2).eval()
    plain = make()
    FAULTS["temporal_head_zeroed"](None, monkeypatch.setattr)
    marked = make()
    marked.load_state_dict(plain.state_dict())
    attn, seen = marked.blocks[-1].attn, []
    attn.proj.register_forward_pre_hook(lambda module, inputs: seen.append(inputs[0]))
    x = torch.randn(4, 9, 16, 2, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        moved = (marked(x) - plain(x)).abs().max()
    width = attn.proj.in_features // attn.num_heads
    assert seen and not seen[0][..., :width].any() and seen[0][..., width:].abs().max() > 0
    assert moved > 1e-6


def test_control_reads_far_above_the_sound_run():
    """The reference with TF32 products, the attention's included, against
    the reference, at the tiny size: it fails the tiny limits, on a number
    ten times the sound run's or more."""
    sound = tiny.values(tiny.sound())
    cut = tiny.spec()
    threads = torch.get_num_threads()
    torch.set_num_threads(tiny.THREADS)
    try:
        values = harness.runner_of(cut).control(cut.config, cut.traffic, pool.seeds(11),
                                                torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    assert not checks.judge(values, cut.limits), values
    assert any(values[k] > 10 * sound[k] for k in cut.limits), values


def test_reference_projection_keeps_a_finite_gradient_at_zero_depth():
    """Inside the PoseFormer follow the generator's projection takes a point
    at depth exactly 0 as a constant: values and every other point's
    gradient are ``geometry.project_to_2d``'s bit for bit, that point's
    gradient is 0 where the plain divide's is NaN, and the plain function is
    back in place afterwards."""
    from benchmark.reference import follow_poseformer, geometry

    gen = torch.Generator().manual_seed(3)
    X = torch.randn(6, 16, 3, generator=gen)
    X[..., 2] += 4.0
    X[2, 5] = torch.tensor([0.3, -0.2, 0.0])
    cam = torch.cat([torch.full((6, 2), 1.1), torch.zeros(6, 2),
                     0.01 * torch.randn(6, 5, generator=gen)], dim=1)
    weight = torch.randn(6, 16, 2, generator=gen)

    def project(fn):
        x = X.clone().requires_grad_(True)
        out = fn(x, cam)
        (out * weight).sum().backward()
        return out.detach(), x.grad

    plain_out, plain_grad = project(geometry.project_to_2d)
    with follow_poseformer.finite_projection():
        assert geometry.project_to_2d is follow_poseformer.project_to_2d_finite
        out, grad = project(geometry.project_to_2d)
    assert geometry.project_to_2d is follow_poseformer._PROJECT_TO_2D
    flat = torch.zeros(6, 16, dtype=torch.bool)
    flat[2, 5] = True
    assert torch.equal(out, plain_out)
    assert plain_grad[flat].isnan().any() and torch.equal(grad[flat], torch.zeros(1, 3))
    assert torch.equal(grad[~flat], plain_grad[~flat])
