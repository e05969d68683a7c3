"""Runner of video-mode augmented training with PoseFormer: the program's
side is ``video_train``'s (the same epoch functions, in the same order, on
the cell's clips of F frames), and the check follows it with the reference
PoseFormer (``benchmark/reference/follow_poseformer.py``)."""
from __future__ import annotations

import torch

from benchmark import checks
from benchmark.reference import follow_poseformer
from benchmark.reference import geometry as geo
from benchmark.runners.video_train import CHECK_STEPS, TERMS, chunk, setup  # noqa: F401


def check(state: dict, run) -> dict:
    """Drop the program's state, follow the first steps with the
    reference, and return the gaps."""
    record, config, traffic = state.pop("record"), state["config"], state["traffic"]
    state.clear()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    reference = follow_poseformer.follow_video(config, traffic, run.seeds, run.device,
                                               CHECK_STEPS)
    return checks.training_gaps(record, reference, TERMS, geo.bone_lengths_fk,
                                geo.project_to_2d)


def control(config: dict, traffic: dict, seeds: list, device) -> dict:
    """The control's gaps: the reference with TF32 products in the
    program's place, against the reference."""
    ref = follow_poseformer.follow_video(config, traffic, seeds, device, CHECK_STEPS)
    low = follow_poseformer.follow_video(config, traffic, seeds, device, CHECK_STEPS, "tf32")
    return checks.training_gaps(low, ref, TERMS, geo.bone_lengths_fk, geo.project_to_2d)
