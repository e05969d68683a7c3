"""The algorithmic work of the PoseFormer video cell, counted as
``flops.py`` counts: a product of an ``in`` x ``out`` dense layer over
``rows`` rows is one pass of 2 * rows * in * out FLOPs, and a posenet step
takes 3 passes of each layer (forward, weight gradient, propagated
gradient), 2 of the layer that reads the clips.  Attention's two batched
products, Q K^T and A V, over ``n`` tokens of width ``w`` (all heads) are
2 * n * n * w FLOPs each a sequence and a pass, and take 3 passes too
(forward and the gradients of both operands).  LayerNorm, softmax, GELU,
stochastic depth, the embeddings' sums and the loss are not counted.
"""
from __future__ import annotations

import math

from benchmark.counts import flops

JOINTS = 16


def _transformer(rows: int, seqs: int, tokens: int, width: int, depth: int,
                 mlp_ratio: float) -> float:
    """FLOPs of one pass through ``depth`` blocks on ``seqs`` sequences of
    ``tokens`` tokens (``rows`` = seqs x tokens) at ``width``."""
    hidden = int(width * mlp_ratio)
    dense = [(width, 3 * width, False), (width, width, False), (width, hidden, False),
             (hidden, width, False)]
    return depth * (flops.passes(dense, rows) + 2 * 2.0 * seqs * tokens * tokens * width)


def train_step(posenet: dict, clips: int) -> float:
    """FLOPs of one PoseFormer optimizer step on ``clips`` clips."""
    frames = math.prod(posenet["filter_widths"])
    C, depth, ratio = posenet["embed_dim_ratio"], posenet["depth"], posenet["mlp_ratio"]
    E = C * JOINTS
    one_pass = (_transformer(clips * frames * JOINTS, clips * frames, JOINTS, C, depth, ratio)
                + _transformer(clips * frames, clips, frames, E, depth, ratio)
                + flops.passes([(frames, 1, False)], clips * E)        # the weighted mean
                + flops.passes([(E, JOINTS * 3, False)], clips))       # the head
    embed = flops.passes([(2, C, True)], clips * frames * JOINTS)
    return 3 * one_pass + 2 * embed


def video_iteration(config: dict, traffic: dict) -> dict:
    """FLOPs of one video iteration: the GAN's, as ``flops.video_iteration``
    counts them at the cell's frame count, and the 8 PoseFormer steps a
    batch (mirror and playback duplicates of both passes)."""
    p, B = config["posenet"], traffic["batch"]
    # a VideoPose of no channels does no work: what is left is the GAN's
    gan = flops.video_iteration({"gan": config["gan"],
                                 "posenet": {"filter_widths": p["filter_widths"],
                                             "channels": 0}}, traffic)["gan"]
    posenet = 8 * train_step(p, B)
    return {"gan": gan, "posenet": posenet, "total": gan + posenet}
