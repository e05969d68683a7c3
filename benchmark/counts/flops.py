"""The algorithmic work of the cells, from layer shapes: the yardstick of the
MFU and roofline metrics.  Nothing the program does twice is counted
twice, and nothing it could skip is counted.

A product of an ``in`` x ``out`` dense layer (or a convolution's im2col
product) over ``rows`` rows is one *pass*, 2 * rows * in * out FLOPs.

* One WGAN-GP critic update: forwards on the real, fake and interpolated
  rows (3 passes); the penalty's input gradient (1); the weight gradient
  and the propagated gradient of the real and fake scores (4); the
  penalty's double backward, through the input-gradient products and then
  the interpolates' forward (4): 12 passes a layer, 9 for a layer that
  reads the net's input, whose propagated gradients are not needed.
* A generator update: its forward, weight gradient and propagated
  gradient (3 passes, 2 for its input layer); each critic scored with
  gradient takes its forward and propagated gradient (2), each scored
  without (the mirrored branches) its forward (1).
* A posenet step: forward, weight gradient, propagated gradient (3
  passes, 2 for the input layer).  Batch norm, dropout, activations, the
  FK and all elementwise work are not counted.
"""
from __future__ import annotations

import math

NOISE = 128
HEAD = 35


def passes(layers, rows: int) -> float:
    """FLOPs of one pass over ``layers`` [(in, out, is_input), ...]."""
    return 2.0 * rows * sum(i * o for i, o, _ in layers)


def weighted(layers, rows: int, per_layer: float, per_input_layer: float) -> float:
    return 2.0 * rows * sum(i * o * (per_input_layer if first else per_layer)
                            for i, o, first in layers)


def tower(in_dim: int, d: int):
    return [(in_dim, d, True)] + [(d, d, False)] * 6


def generator_layers(d: int, frames: int = 1):
    return [(NOISE, d, True)] + [(d, d, False)] * 6 + [(d, frames * HEAD, False)]


def critic3d_layers(d: int):
    return tower(30, d) + tower(48, d) + [(2 * d, 100, False), (100, 100, False),
                                          (100, 100, False), (100, 1, False)]


def critic2d_layers(d: int):
    return [(32, d, True)] + [(d, d, False)] * 4 + [(d, 1, False)]


def motion3d_layers(frames: int, d: int):
    return (tower(frames * 15, d) + tower((frames - 1) * 15, d) + tower(frames * 48, d)
            + tower((frames - 1) * 48, d)
            + [(4 * d, 100, False), (100, 100, False), (100, 100, False), (100, 1, False)])


def motion2d_layers(frames: int, d: int):
    return (tower(frames * 32, d) + tower((frames - 1) * 2, d)
            + [(2 * d, 100, False), (100, 100, False), (100, 100, False), (100, 1, False)])


def videopose_layers(widths, channels: int):
    """Per-clip im2col products of the strided net: (in x kernel, out)
    counted once per output frame."""
    frames = math.prod(widths)
    out_frames = frames // widths[0]
    layers = [(32 * widths[0] * out_frames, channels, True)]
    for w in widths[1:]:
        out_frames //= w
        layers += [(channels * w * out_frames, channels, False),
                   (channels * out_frames, channels, False)]
    return layers + [(channels * out_frames, 48, False)]


def critic_update(layers, rows: int) -> float:
    return weighted(layers, rows, 12, 9)


def train_step(layers, rows: int) -> float:
    return weighted(layers, rows, 3, 2)


def video_iteration(config: dict, traffic: dict) -> dict:
    """FLOPs of one video iteration (motion critics on, mirror and
    playback duplicates): GAN work and the 8 posenet steps a batch."""
    g, p, B = config["gan"], config["posenet"], traffic["batch"]
    F = math.prod(p["filter_widths"])
    gen = generator_layers(g["gen_dense"], F)
    d3, d2 = critic3d_layers(g["dis_dense_3d"]), critic2d_layers(g["dis_dense_2d"])
    m3 = motion3d_layers(F, g["video_dis_dense_3d"])
    m2 = motion2d_layers(F, g["video_dis_dense_2d"])
    critics = (2 * critic_update(d3, B * F) + 2 * critic_update(d2, B * F)
               + 4 * critic_update(m3, B) + 4 * critic_update(m2, B))
    gen_step = (train_step(gen, B) + 3 * passes(d3, B * F) + 3 * passes(d2, B * F)
                + 6 * passes(m3, B) + 6 * passes(m2, B))
    gan = critics + passes(gen, B) + gen_step / 5
    posenet = 8 * train_step(videopose_layers(p["filter_widths"], p["channels"]), B)
    return {"gan": gan, "posenet": posenet, "total": gan + posenet}


def trunk(d: int, rows: int) -> dict:
    """Kernel B3 (the generator trunk in bf16 products) on ``rows`` noise
    rows: its FLOPs and the bytes it must move (noise in, bf16 weights and
    fp32 biases in, the fp32 head out)."""
    layers = generator_layers(d)
    weights = sum(i * o for i, o, _ in layers)
    biases = sum(o for _, o, _ in layers)
    return {"flop": passes(layers, rows),
            "bytes": 4.0 * rows * NOISE + 2.0 * weights + 4.0 * biases + 4.0 * rows * HEAD}


# fp32 adds and multiplies a pose of the forward DH-FK (33 links of
# theta/Q/t, 30 chain steps, the Euler rotation, 16 joints rotated and
# moved), counted from the published equations
FK_FLOP_PER_POSE = 33 * 8 + 30 * 63 + 27 + 16 * 18


def fk_forward(rows: int) -> dict:
    """Kernel B1 on ``rows`` poses: 33 angles, 15 bone lengths, 3 rotation
    angles and the root in, the (16, 3) pose out, fp32."""
    return {"flop": float(FK_FLOP_PER_POSE * rows),
            "bytes": 4.0 * rows * (33 + 15 + 3 + 3 + 16 * 3)}
