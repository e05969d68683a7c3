"""The port's PoseFormer against the benchmark's plain float32 reference
(``benchmark/reference/poseformer.py``), on the CPU at a small size
(9 frames, embedding 8 a joint, depth 2, 2 heads; the published drop-path
rate 0.1), from one seeded weight draw (``nets.init_weights``) given to
both: the forward in eval and in train mode, one batch of the video
posenet steps, and a run of the cell ``video-train-poseformer`` cut to
``benchmark/tests/tiny.py``'s size that must read ``correct`` under
limits read at that size.

Both sides make the same float32 operations in the same order and draw
the same stochastic depth masks from one generator, so on one machine they
agree to the last bit; each tolerance below leaves room for a reduction
that sums in another order (a float32 ulp or a few at the values'
scale), and none for a dropped branch, a skipped draw or a wrong mask,
which move the outputs by a tenth or more.
"""
from __future__ import annotations

import torch

from benchmark.reference import steps
from benchmark.reference.nets import init_weights
from benchmark.reference.poseformer import PoseFormer as Reference
from benchmark.tests import tiny_poseformer
from dhaug_torch.models.posenets import PoseFormer
from dhaug_torch.train.posenet import video_steps
from dhaug_torch.train.state import adam_posenet

SMALL = dict(frames=9, embed_dim_ratio=8, depth=2, num_heads=2, drop_path_rate=0.1)
TOL = dict(rtol=1e-5, atol=1e-6)


def _pair(seed: int = 0):
    """The port's and the reference's PoseFormer at ``SMALL``, one seeded
    weight draw given to both."""
    s = SMALL
    port = PoseFormer(num_frame=s["frames"], embed_dim_ratio=s["embed_dim_ratio"],
                      depth=s["depth"], num_heads=s["num_heads"],
                      drop_path_rate=s["drop_path_rate"])
    ref = Reference(s["frames"], 16, s["embed_dim_ratio"], s["depth"], s["num_heads"], 2.0,
                    s["drop_path_rate"])
    assert list(port.state_dict()) == list(ref.state_dict())
    for net in (port, ref):
        init_weights([net], torch.Generator().manual_seed(seed))
    return port, ref


def _clips(n: int, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    x = 0.3 * torch.randn(n, SMALL["frames"], 16, 2, generator=g)
    y = 0.2 * torch.randn(n, 1, 16, 3, generator=g)
    return x, y - y[..., :1, :]


def test_forward_in_eval_mode_matches_the_reference():
    port, ref = _pair()
    port.eval()
    ref.eval()
    x, _ = _clips(32)
    with torch.no_grad():
        torch.testing.assert_close(port(x), ref(x), **TOL)


def test_forward_in_train_mode_draws_the_same_stochastic_depth():
    """From one generator seed both sides drop the same samples' branches;
    the masks do drop some (train differs from eval), and another seed
    drops others."""
    port, ref = _pair()
    x, _ = _clips(32)
    with torch.no_grad():
        a = port.train()(x, torch.Generator().manual_seed(5))
        b = ref.train()(x, torch.Generator().manual_seed(5))
        torch.testing.assert_close(a, b, **TOL)
        other = port(x, torch.Generator().manual_seed(6))
        still = port.eval()(x)
    assert (a - other).abs().max() > 1e-2 and (a - still).abs().max() > 1e-2


def test_video_steps_with_flip_and_playback_match_the_reference():
    """One batch of the video passes (the clip step, its playback, its
    mirror and the mirrored playback, each a clipped Adam step): the base
    step's loss, every gradient of the last step, Adam's first moments
    and the weights after the four steps."""
    port, ref = _pair()
    x, y = _clips(24)
    opt = adam_posenet(port.parameters())
    ref_opt = torch.optim.Adam(ref.parameters(), lr=1e-4, betas=(0.9, 0.999))
    loss = video_steps(port, opt, x, y, 1.0, torch.Generator().manual_seed(7), flip=True,
                       playback=True)
    ref_loss = steps.video_posenet_steps(ref, ref_opt, x, y, 1.0,
                                         torch.Generator().manual_seed(7), playback=True)
    torch.testing.assert_close(loss, ref_loss, **TOL)
    for (name, p), r in zip(port.named_parameters(), ref.parameters()):
        for a, b in ((p.grad, r.grad), (opt.state[p]["exp_avg"], ref_opt.state[r]["exp_avg"]),
                     (p.detach(), r.detach())):
            torch.testing.assert_close(a, b, **TOL, msg=lambda m, name=name: f"{name}: {m}")


def test_tiny_cell_run_on_the_cpu_is_correct():
    """The cell's set-up, one window chunk and its check at the tiny size
    (PoseFormer at its published widths and 81 frames, 8 clips a batch,
    nets of the GAN 32 wide): the program's path against the reference's
    follow, under limits read at that size (``benchmark/tests/
    tiny_poseformer.py`` gives them and their readings; the card's, set at
    512 clips a batch, are narrower than this size's rounding spread)."""
    line = tiny_poseformer.sound()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == tiny_poseformer.spec().traffic["chunk_batches"]
