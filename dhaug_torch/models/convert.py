"""Weight transfer from the JAX package's parameters into the port's modules.

Input: flax variables as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), under flax's auto-names
(``DensePrelude_0/Dense_0``, ``DenseResBlock_i``, ``BatchNorm_i``, ...).
A flax ``Dense`` kernel is (in, out); the torch ``weight`` is (out, in).
Every leaf is consumed exactly once and shapes are checked, so a mismatch
between the two model definitions fails loudly.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from dhaug_torch.models.blocks import DensePrelude, DenseResBlock, ResTower
from dhaug_torch.models.discriminators import Fk2DDiscriminator, Fk3DDiscriminator
from dhaug_torch.models.generator import FkGeneratorNet
from dhaug_torch.models.posenets import LinearModel


def _copy(dst: torch.Tensor, src, name: str):
    src = torch.tensor(np.asarray(src, np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dst.device))


def _dense(layer: nn.Linear, p: Mapping, name: str):
    if set(p) != {"kernel", "bias"}:
        raise ValueError(f"{name}: expected kernel/bias, got {sorted(p)}")
    _copy(layer.weight, np.asarray(p["kernel"]).T, f"{name}/kernel")
    _copy(layer.bias, p["bias"], f"{name}/bias")


def _keys(p: Mapping, expected, name: str):
    if set(p) != set(expected):
        raise ValueError(f"{name}: expected {sorted(expected)}, got {sorted(p)}")


def _prelude(m: DensePrelude, p: Mapping, name: str):
    _keys(p, ["Dense_0"], name)
    _dense(m.fc, p["Dense_0"], f"{name}/Dense_0")


def _res_block(m: DenseResBlock, p: Mapping, name: str):
    _keys(p, ["Dense_0", "Dense_1"], name)
    _dense(m.fc1, p["Dense_0"], f"{name}/Dense_0")
    _dense(m.fc2, p["Dense_1"], f"{name}/Dense_1")


def _tower(m: ResTower, p: Mapping, name: str):
    _keys(p, ["DensePrelude_0"] + [f"DenseResBlock_{i}" for i in range(len(m.blocks))], name)
    _prelude(m.prelude, p["DensePrelude_0"], f"{name}/DensePrelude_0")
    for i, block in enumerate(m.blocks):
        _res_block(block, p[f"DenseResBlock_{i}"], f"{name}/DenseResBlock_{i}")


def load_generator(net: FkGeneratorNet, params: Mapping) -> FkGeneratorNet:
    _keys(params, ["DensePrelude_0", "DenseResBlock_0", "DenseResBlock_1",
                   "DenseResBlock_2", "Dense_0"], "generator")
    _prelude(net.prelude, params["DensePrelude_0"], "DensePrelude_0")
    for i, block in enumerate(net.blocks):
        _res_block(block, params[f"DenseResBlock_{i}"], f"DenseResBlock_{i}")
    _dense(net.head, params["Dense_0"], "Dense_0")
    return net


def load_d3d(net: Fk3DDiscriminator, params: Mapping) -> Fk3DDiscriminator:
    _keys(params, ["ResTower_0", "ResTower_1", "DensePrelude_0",
                   "DenseResBlock_0", "Dense_0"], "d3d")
    _tower(net.kcs_tower, params["ResTower_0"], "ResTower_0")
    _tower(net.pose_tower, params["ResTower_1"], "ResTower_1")
    _prelude(net.merge, params["DensePrelude_0"], "DensePrelude_0")
    _res_block(net.merge_block, params["DenseResBlock_0"], "DenseResBlock_0")
    _dense(net.out, params["Dense_0"], "Dense_0")
    return net


def load_d2d(net: Fk2DDiscriminator, params: Mapping) -> Fk2DDiscriminator:
    layers = [net.fc1, net.fc2, net.fc3, net.fc4, net.fc5, net.out]
    _keys(params, [f"Dense_{i}" for i in range(len(layers))], "d2d")
    for i, layer in enumerate(layers):
        _dense(layer, params[f"Dense_{i}"], f"Dense_{i}")
    return net


def _batch_norm(bn: nn.BatchNorm1d, p: Mapping, stats: Mapping, name: str):
    _keys(p, ["scale", "bias"], name)
    _keys(stats, ["mean", "var"], f"{name} batch_stats")
    _copy(bn.weight, p["scale"], f"{name}/scale")
    _copy(bn.bias, p["bias"], f"{name}/bias")
    _copy(bn.running_mean, stats["mean"], f"{name}/mean")
    _copy(bn.running_var, stats["var"], f"{name}/var")


def load_linear_model(net: LinearModel, params: Mapping,
                      batch_stats: Mapping) -> LinearModel:
    """``LinearModel`` from its flax params and ``batch_stats``."""
    stages = [f"_LinearStage_{i}" for i in range(len(net.stages))]
    _keys(params, ["Dense_0", "BatchNorm_0", "Dense_1"] + stages, "mlp")
    _keys(batch_stats, ["BatchNorm_0"] + stages, "mlp batch_stats")
    _dense(net.fc_in, params["Dense_0"], "Dense_0")
    _batch_norm(net.bn_in, params["BatchNorm_0"], batch_stats["BatchNorm_0"], "BatchNorm_0")
    for name, stage in zip(stages, net.stages):
        p, s = params[name], batch_stats[name]
        _keys(p, ["Dense_0", "BatchNorm_0", "Dense_1", "BatchNorm_1"], name)
        _keys(s, ["BatchNorm_0", "BatchNorm_1"], f"{name} batch_stats")
        _dense(stage.fc1, p["Dense_0"], f"{name}/Dense_0")
        _batch_norm(stage.bn1, p["BatchNorm_0"], s["BatchNorm_0"], f"{name}/BatchNorm_0")
        _dense(stage.fc2, p["Dense_1"], f"{name}/Dense_1")
        _batch_norm(stage.bn2, p["BatchNorm_1"], s["BatchNorm_1"], f"{name}/BatchNorm_1")
    _dense(net.fc_out, params["Dense_1"], "Dense_1")
    return net
