"""The port's span recorder (``dhaug_torch/utils/profiling.py``) on the CPU:
off, a span opens no annotation and keeps nothing, at well under a
microsecond's budget; under ``torch.profiler`` spans nest, name their
parent and root, report self time, read kineto's clock and count the
"synchronizing CUDA operation" warnings without showing them; and a tiny
video GAN epoch, posenet pass and synthesis dispatch make the spans the
benchmark's readers count, without moving the program's results."""
import statistics
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dhaug_torch.data.chunked import ChunkWindows
from dhaug_torch.gan.video import build_video_gan, run_video_gan_epoch
from dhaug_torch.gan.wgan import camera_bank, tiled_cam16
from dhaug_torch.models.factory import make_posenet
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
from dhaug_torch.models.trunk_cuda import trunk_weights
from dhaug_torch.parallel.sharded import make_sharded_synthesizer
from dhaug_torch.synthesize_dataset import synth_pairs
from dhaug_torch.train.config import parse_aug_args
from dhaug_torch.train.posenet import train_video_clips
from dhaug_torch.train.state import adam_posenet
from dhaug_torch.utils import profiling
from dhaug_torch.utils.log import Summary

# the benchmark's video command (benchmark/configs/dhaug-video-videopose.json)
# at narrow widths and a small batch
WIDTH, B = 32, 8
VIDEO_ARGV = ["--posenet_name", "mulit_farme_videopose", "--single_or_multi_train_mode",
              "multi", "--architecture", "3,3", "--batch_size", str(B),
              "--data_enhancement_method", "GAN", "--Gen_DenseDim", str(WIDTH),
              "--Dis_DenseDim_3D", str(WIDTH), "--Dis_DenseDim_2D", str(WIDTH),
              "--video_Dis_DenseDim_3D", str(WIDTH), "--video_Dis_DenseDim_2D", str(WIDTH)]
CRITIC_UPDATES = {"gan.critic.d3d": 2, "gan.critic.md3d": 4, "gan.critic.d2d": 2,
                  "gan.critic.md2d": 4}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _new_records(fn):
    """(fn's result, the spans it recorded, the profile) under a CPU profile."""
    first = len(profiling.span_records())
    out, prof = _profiled(fn)
    return out, profiling.span_records()[first:], prof


def _children(records, parent):
    return [r for r in records if r.parent_id == parent.span_id]


def test_span_off_opens_no_annotation_and_keeps_no_record(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    before = len(profiling.span_records())

    @profiling.spanned("test.off")
    def work(x):
        """doc"""
        with profiling.span("test.inner"):
            return x + 1

    assert work(1) == 2 and work.__name__ == "work" and work.__doc__ == "doc"
    assert profiling.span("a") is profiling.span("b")       # one shared no-op
    assert opened == [] and len(profiling.span_records()) == before


def test_spans_nest_with_parents_roots_and_self_time():
    def block():
        with profiling.span("t.root"):
            with profiling.span("t.root.a"):
                time.sleep(0.003)
                with profiling.span("t.root.a.x"):
                    time.sleep(0.002)
            with profiling.span("t.root.b"):
                time.sleep(0.001)
            time.sleep(0.002)
        with profiling.span("t.second"):
            pass

    _, records, _ = _new_records(block)
    by = {r.name: r for r in records}
    assert [r.name for r in records] == ["t.root.a.x", "t.root.a", "t.root.b", "t.root",
                                         "t.second"]
    root, a, x, b, second = (by[n] for n in ("t.root", "t.root.a", "t.root.a.x", "t.root.b",
                                             "t.second"))
    assert root.parent_id == second.parent_id == -1
    assert (a.parent_id, b.parent_id, x.parent_id) == (root.span_id, root.span_id, a.span_id)
    assert a.root == b.root == x.root == root.root and second.root == root.root + 1
    assert root.span_id < a.span_id < x.span_id < b.span_id < second.span_id
    assert root.start_ns <= a.start_ns <= x.start_ns <= x.end_ns <= a.end_ns \
        <= b.start_ns <= b.end_ns <= root.end_ns
    assert root.child_ns == (a.end_ns - a.start_ns) + (b.end_ns - b.start_ns)
    assert root.self_ms == pytest.approx(root.ms - a.ms - b.ms, abs=1e-9)
    assert a.self_ms == pytest.approx(a.ms - x.ms, abs=1e-9) and x.self_ms == x.ms
    assert 1.5 <= root.self_ms and 2.5 <= a.self_ms
    table = profiling.span_summary(records)
    assert table["t.root.a"] == {"calls": 1, "total_ms": a.ms, "self_ms": a.self_ms,
                                 "syncs": 0}
    assert set(table) == set(by)


def test_span_clock_is_the_profilers():
    """Each span's start lies within 1 ms of its kineto annotation's."""
    def block():
        for _ in range(3):
            with profiling.span("t.clock"):
                with profiling.span("t.clock.inner"):
                    torch.ones(32, 32) @ torch.ones(32, 32)

    _, records, prof = _new_records(block)
    notes = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name().startswith("t.clock"))
    ours = sorted((r.start_ns, r.name) for r in records)
    assert [n for _, n in notes] == [n for _, n in ours] and len(ours) == 6
    for (theirs, _), (mine, _) in zip(notes, ours):
        assert abs(theirs - mine) < 1_000_000


def test_sync_warnings_are_counted_on_the_innermost_span_and_not_shown(capsys):
    filters, shown = list(warnings.filters), warnings.showwarning

    def block():
        with profiling.span("t.sync"):
            warnings.warn(profiling.SYNC_WARNING)
            with profiling.span("t.sync.inner"):
                for _ in range(2):
                    warnings.warn(profiling.SYNC_WARNING + " (Triggered internally)")
                assert warnings.filters != filters
            warnings.warn("an unrelated warning")

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _, records, _ = _new_records(block)
    by = {r.name: r for r in records}
    assert (by["t.sync"].syncs, by["t.sync.inner"].syncs) == (1, 2)
    assert [str(w.message) for w in seen] == ["an unrelated warning"]
    assert warnings.filters == filters and warnings.showwarning is shown
    assert profiling.SYNC_WARNING not in capsys.readouterr().err
    assert profiling.span_summary(records)["t.sync.inner"]["syncs"] == 2


def test_a_root_sets_the_sync_debug_mode_only_where_cuda_is_in_use(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def block():
        with profiling.span("t.mode"):
            with profiling.span("t.mode.inner"):
                pass

    _new_records(block)
    assert modes == []                      # CUDA not initialized: untouched
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    _new_records(block)
    assert modes == ["warn", 0]             # set by the root, restored when it closes


def test_span_off_costs_at_most_a_few_microseconds():
    """The CPU loop of PERF.md: 10^5 spans with no profiler on, median of
    5 loops, under a ceiling loose enough for a slow host."""
    def loop(n=100_000):
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("t.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    assert statistics.median(loop() for _ in range(5)) < 10.0


def _tiny_video(seed: int):
    """The narrow video GAN, a VideoPose net, a full-window clip loader of
    6 batches and a posenet optimizer, all from ``seed``."""
    torch.manual_seed(seed)
    args = parse_aug_args(VIDEO_ARGV)
    subjects = ["S1", "S5"]
    gan = build_video_gan(args, subjects, 9, "cpu")
    posenet = make_posenet(args.posenet_name, flag="train", stages=args.stages,
                           dropout=args.dropout, architecture=args.architecture)
    q, t, i = camera_bank(subjects[:1])
    rng = np.random.default_rng(seed)
    lengths = (20, 28)
    loader = ChunkWindows(B, [tiled_cam16(i[0], q[0], t[0], 1)[0].numpy()] * 2,
                          [rng.normal(0, .3, (n, 16, 3)).astype(np.float32) + [0, 0, 5]
                           for n in lengths],
                          [rng.normal(0, .3, (n, 16, 2)).astype(np.float32) for n in lengths],
                          pad=4, full_3d_window=True, random_seed=seed)
    return SimpleNamespace(args=args, gan=gan, posenet=posenet, loader=loader, rng=rng,
                           opt=adam_posenet(posenet.parameters(), args.lr_p),
                           generator=torch.Generator().manual_seed(seed))


def _video_chunk(v, first_iteration: int):
    """The GAN epoch from ``first_iteration`` on, then the posenet pass on
    its fake clips: the order of the benchmark's video runner."""
    summary = Summary(None)
    summary.train_iter_num = first_iteration
    f3d, f2d, _ = run_video_gan_epoch(v.gan, v.loader, B, v.generator, summary, True)
    loss = train_video_clips(v.posenet, v.opt, f2d, f3d[:, 4:5], v.rng, B, 1.0, v.generator,
                             v.args.flip_pos_model_input, v.args.GAN_video_playback_input)
    return f3d, f2d, loss


def test_video_epoch_and_posenet_pass_make_the_counted_spans():
    torch.set_num_threads(2)
    first = 2                                   # global iteration 4 is the 3rd batch
    plain = _video_chunk(_tiny_video(5), first)
    traced, records, _ = _new_records(lambda: _video_chunk(_tiny_video(5), first))
    # the spans move none of the program's draws, orders or numbers
    assert all(torch.equal(a, b) for a, b in zip(plain[:2], traced[:2]))
    assert plain[2] == traced[2]

    (epoch,) = [r for r in records if r.name == "gan.epoch"]
    assert epoch.parent_id == -1
    iterations = [r for r in _children(records, epoch) if r.name == "gan.iteration"]
    assert len(iterations) == 48 // B
    assert {r.name for r in _children(records, epoch)} == {"gan.iteration", "gan.scalars",
                                                            "data.upload"}
    for b, it in enumerate(iterations):
        kids = [r.name for r in _children(records, it)]
        assert {n: kids.count(n) for n in CRITIC_UPDATES} == CRITIC_UPDATES
        assert kids.count("gan.fake") == 1
        assert kids.count("gan.generator") == (1 if (first + b) % 5 == 4 else 0)
        for update in (r for r in _children(records, it) if r.name.startswith("gan.critic.")):
            assert [c.name for c in _children(records, update)] == [
                update.name + part for part in (".forward", ".grad", ".optimizer")]
    assert all(r.root == epoch.root for r in records if r.start_ns <= epoch.end_ns)

    (pass_,) = [r for r in records if r.name == "posenet.pass"]
    steps = _children(records, pass_)
    v = _tiny_video(5)
    per_batch = (2 if v.args.flip_pos_model_input else 1) * \
        (2 if v.args.GAN_video_playback_input else 1)
    assert [r.name for r in steps] == ["posenet.step"] * (len(iterations) * per_batch)
    for step in steps:
        assert [c.name for c in _children(records, step)] == [
            "posenet.forward", "posenet.backward", "posenet.optimizer"]
    assert pass_.root == epoch.root + 1
    assert sum(r.syncs for r in records) == 0    # no CUDA here


def test_synthesis_dispatch_makes_its_four_parts():
    cfg = GeneratorConfig(dense_dim=WIDTH)
    torch.manual_seed(3)
    ops = trunk_weights(FkGeneratorNet(cfg).eval())
    synthesize = make_sharded_synthesizer(cfg)
    cameras = camera_bank(["S1"])
    bones = torch.full((16, 15), 0.3)
    draw = lambda: synth_pairs(synthesize, ops, bones, cameras, torch.Generator().manual_seed(4))
    plain = draw()
    traced, records, _ = _new_records(draw)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    (dispatch,) = [r for r in records if r.name == "synth.dispatch"]
    assert dispatch.parent_id == -1
    assert [r.name for r in _children(records, dispatch)] == [
        "synth.trunk", "synth.angles", "synth.fk", "synth.project"]
    assert dispatch.self_ms >= 0 and dispatch.syncs == 0
