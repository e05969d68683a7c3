"""Weight transfer from the JAX package's parameters into the port's modules.

Input: flax variables as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), under flax's auto-names
(``DensePrelude_0/Dense_0``, ``DenseResBlock_i``, ``BatchNorm_i``, ...).
A flax ``Dense`` kernel is (in, out); the torch ``weight`` is (out, in); a
flax ``Conv`` kernel is (k, in, out), the ``Conv1d`` weight (out, in, k).
Every leaf is consumed exactly once and shapes are checked, so a mismatch
between the two model definitions fails loudly.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from dhaug_torch.models.blocks import DensePrelude, DenseResBlock, ResTower
from dhaug_torch.models.discriminators import (Fk2DDiscriminator, Fk3DDiscriminator,
                                              MotionFk2DDiscriminator,
                                              MotionFk3DDiscriminator)
from dhaug_torch.models.generator import FkGeneratorNet
from dhaug_torch.models.posenets import (Block, LinearModel, PoseFormer, SemGCN, SemGraphConv,
                                        TemporalPoseNet)


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


def _merge_head(net, params: Mapping):
    _prelude(net.merge, params["DensePrelude_0"], "DensePrelude_0")
    _res_block(net.merge_block, params["DenseResBlock_0"], "DenseResBlock_0")
    _dense(net.out, params["Dense_0"], "Dense_0")


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
    _merge_head(net, params)
    return net


def load_d2d(net: Fk2DDiscriminator, params: Mapping) -> Fk2DDiscriminator:
    layers = [net.fc1, net.fc2, net.fc3, net.fc4, net.fc5, net.out]
    _keys(params, [f"Dense_{i}" for i in range(len(layers))], "d2d")
    for i, layer in enumerate(layers):
        _dense(layer, params[f"Dense_{i}"], f"Dense_{i}")
    return net


def load_md3d(net: MotionFk3DDiscriminator, params: Mapping) -> MotionFk3DDiscriminator:
    """The motion 3D critic; flax numbers its towers in branch order (KCS,
    diff-KCS, then the raw-3D and diff-3D towers that are switched on)."""
    towers = [t for t in (net.kcs_tower, net.kcs_diff_tower, net.pose_tower,
                          net.pose_diff_tower) if t is not None]
    names = [f"ResTower_{i}" for i in range(len(towers))]
    _keys(params, names + ["DensePrelude_0", "DenseResBlock_0", "Dense_0"], "md3d")
    for name, tower in zip(names, towers):
        _tower(tower, params[name], name)
    _merge_head(net, params)
    return net


def load_md2d(net: MotionFk2DDiscriminator, params: Mapping) -> MotionFk2DDiscriminator:
    _keys(params, ["ResTower_0", "ResTower_1", "DensePrelude_0", "DenseResBlock_0",
                   "Dense_0"], "md2d")
    _tower(net.pose_tower, params["ResTower_0"], "ResTower_0")
    _tower(net.root_diff_tower, params["ResTower_1"], "ResTower_1")
    _merge_head(net, params)
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
    stages = [f"_LinearStage_{i}" for i in range(len(net.linear_stages))]
    _keys(params, ["Dense_0", "BatchNorm_0", "Dense_1"] + stages, "mlp")
    _keys(batch_stats, ["BatchNorm_0"] + stages, "mlp batch_stats")
    _dense(net.w1, params["Dense_0"], "Dense_0")
    _batch_norm(net.batch_norm1, params["BatchNorm_0"], batch_stats["BatchNorm_0"],
                "BatchNorm_0")
    for name, stage in zip(stages, net.linear_stages):
        p, s = params[name], batch_stats[name]
        _keys(p, ["Dense_0", "BatchNorm_0", "Dense_1", "BatchNorm_1"], name)
        _keys(s, ["BatchNorm_0", "BatchNorm_1"], f"{name} batch_stats")
        _dense(stage.w1, p["Dense_0"], f"{name}/Dense_0")
        _batch_norm(stage.batch_norm1, p["BatchNorm_0"], s["BatchNorm_0"],
                    f"{name}/BatchNorm_0")
        _dense(stage.w2, p["Dense_1"], f"{name}/Dense_1")
        _batch_norm(stage.batch_norm2, p["BatchNorm_1"], s["BatchNorm_1"],
                    f"{name}/BatchNorm_1")
    _dense(net.w2, params["Dense_1"], "Dense_1")
    return net


def _sem_graph_conv(m: SemGraphConv, p: Mapping, name: str):
    _keys(p, ["W", "e", "bias"], name)
    _copy(m.W, p["W"], f"{name}/W")
    _copy(m.e, np.asarray(p["e"]).reshape(1, -1), f"{name}/e")
    _copy(m.bias, p["bias"], f"{name}/bias")


def load_semgcn(net: SemGCN, params: Mapping, batch_stats: Mapping) -> SemGCN:
    """``SemGCN`` from flax's ``_GraphConvBlock_i`` (input block, then the
    residual pairs in order) and the output ``SemGraphConv_0``."""
    blocks = [net.gconv_input[0]] + [g for layer in net.gconv_layers
                                     for g in (layer.gconv1, layer.gconv2)]
    names = [f"_GraphConvBlock_{i}" for i in range(len(blocks))]
    _keys(params, names + ["SemGraphConv_0"], "gcn")
    _keys(batch_stats, names, "gcn batch_stats")
    for name, block in zip(names, blocks):
        p, s = params[name], batch_stats[name]
        _keys(p, ["SemGraphConv_0", "BatchNorm_0"], name)
        _keys(s, ["BatchNorm_0"], f"{name} batch_stats")
        _sem_graph_conv(block.gconv, p["SemGraphConv_0"], f"{name}/SemGraphConv_0")
        _batch_norm(block.bn, p["BatchNorm_0"], s["BatchNorm_0"], f"{name}/BatchNorm_0")
    _sem_graph_conv(net.gconv_output, params["SemGraphConv_0"], "SemGraphConv_0")
    return net


def _conv(conv: nn.Conv1d, p: Mapping, name: str):
    """flax Conv kernel (k, C_in, C_out) -> torch Conv1d weight (C_out, C_in, k)."""
    _keys(p, ["kernel"] + (["bias"] if conv.bias is not None else []), name)
    _copy(conv.weight, np.asarray(p["kernel"]).transpose(2, 1, 0), f"{name}/kernel")
    if conv.bias is not None:
        _copy(conv.bias, p["bias"], f"{name}/bias")


def load_temporal_posenet(net: TemporalPoseNet, params: Mapping,
                          batch_stats: Mapping) -> TemporalPoseNet:
    """``TemporalPoseNet`` (either twin) from flax's ``expand_conv``,
    ``conv_{i}a``/``conv_{i}b``, their BatchNorms and ``shrink``."""
    n = len(net.filter_widths) - 1
    bns = ["expand_bn"] + [f"bn_{i}{ab}" for i in range(n) for ab in "ab"]
    convs = ["expand_conv"] + [f"conv_{i}{ab}" for i in range(n) for ab in "ab"]
    _keys(params, convs + bns + ["shrink"], "temporal posenet")
    _keys(batch_stats, bns, "temporal posenet batch_stats")
    for name, conv in zip(convs, [net.expand_conv, *net.layers_conv]):
        _conv(conv, params[name], name)
    for name, bn in zip(bns, [net.expand_bn, *net.layers_bn]):
        _batch_norm(bn, params[name], batch_stats[name], name)
    _conv(net.shrink, params["shrink"], "shrink")
    return net


def _layer_norm(ln: nn.LayerNorm, p: Mapping, name: str):
    _keys(p, ["scale", "bias"], name)
    _copy(ln.weight, p["scale"], f"{name}/scale")
    _copy(ln.bias, p["bias"], f"{name}/bias")


def _mha_block(block: Block, p: Mapping, name: str):
    _keys(p, ["LayerNorm_0", "MultiHeadDotProductAttention_0", "LayerNorm_1",
              "Dense_0", "Dense_1"], name)
    mha = p["MultiHeadDotProductAttention_0"]
    _keys(mha, ["query", "key", "value", "out"], f"{name}/attention")
    dim = block.attn.proj.weight.shape[0]
    for part in ("query", "key", "value", "out"):
        _keys(mha[part], ["kernel", "bias"], f"{name}/attention/{part}")
    # q/k/v kernels (dim, heads, head_dim) stack into qkv's (3 dim, dim) rows
    _copy(block.attn.qkv.weight,
          np.concatenate([np.asarray(mha[k]["kernel"]).reshape(dim, dim).T
                          for k in ("query", "key", "value")]), f"{name}/qkv kernel")
    _copy(block.attn.qkv.bias,
          np.concatenate([np.asarray(mha[k]["bias"]).reshape(dim)
                          for k in ("query", "key", "value")]), f"{name}/qkv bias")
    # out kernel (heads, head_dim, dim): heads concatenated in order
    _copy(block.attn.proj.weight, np.asarray(mha["out"]["kernel"]).reshape(dim, dim).T,
          f"{name}/out kernel")
    _copy(block.attn.proj.bias, mha["out"]["bias"], f"{name}/out bias")
    _layer_norm(block.norm1, p["LayerNorm_0"], f"{name}/LayerNorm_0")
    _layer_norm(block.norm2, p["LayerNorm_1"], f"{name}/LayerNorm_1")
    _dense(block.mlp.fc1, p["Dense_0"], f"{name}/Dense_0")
    _dense(block.mlp.fc2, p["Dense_1"], f"{name}/Dense_1")


def load_poseformer(net: PoseFormer, params: Mapping,
                    batch_stats: Mapping | None = None) -> PoseFormer:
    """``PoseFormer`` from flax's ``patch_embed``, the ``_MHABlock_i``
    (spatial blocks, then temporal), the norms, ``frame_weights``/
    ``frame_bias`` and the head.  It has no BatchNorm."""
    if batch_stats:
        raise ValueError(f"PoseFormer has no batch_stats, got {sorted(batch_stats)}")
    blocks = list(net.Spatial_blocks) + list(net.blocks)
    names = [f"_MHABlock_{i}" for i in range(len(blocks))]
    _keys(params, names + ["patch_embed", "spatial_pos_embed", "temporal_pos_embed",
                           "spatial_norm", "temporal_norm", "frame_weights", "frame_bias",
                           "LayerNorm_0", "head"], "poseformer")
    _dense(net.Spatial_patch_to_embedding, params["patch_embed"], "patch_embed")
    _copy(net.Spatial_pos_embed, params["spatial_pos_embed"], "spatial_pos_embed")
    _copy(net.Temporal_pos_embed, params["temporal_pos_embed"], "temporal_pos_embed")
    for name, block in zip(names, blocks):
        _mha_block(block, params[name], name)
    _layer_norm(net.Spatial_norm, params["spatial_norm"], "spatial_norm")
    _layer_norm(net.Temporal_norm, params["temporal_norm"], "temporal_norm")
    # frame_weights (F, 1) -> Conv1d(F, 1, 1) weight (1, F, 1)
    _copy(net.weighted_mean.weight, np.asarray(params["frame_weights"]).T[:, :, None],
          "frame_weights")
    _copy(net.weighted_mean.bias, params["frame_bias"], "frame_bias")
    _layer_norm(net.head[0], params["LayerNorm_0"], "LayerNorm_0")
    _dense(net.head[1], params["head"], "head")
    return net


_POSENET_LOADERS = {
    "mlp": load_linear_model,
    "gcn": load_semgcn,
    "videopose": load_temporal_posenet,
    "mulit_farme_videopose": load_temporal_posenet,
    "mulit_farme_poseformer": load_poseformer,
}


def load_posenet(name: str, net: nn.Module, params: Mapping,
                 batch_stats: Mapping | None) -> nn.Module:
    """Any of the five ``--posenet_name`` nets from its flax trees."""
    if name not in _POSENET_LOADERS:
        raise ValueError(f"unknown posenet {name!r} (expected one of {sorted(_POSENET_LOADERS)})")
    return _POSENET_LOADERS[name](net, params, batch_stats or {})
