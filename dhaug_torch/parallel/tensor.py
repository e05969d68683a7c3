"""Tensor parallelism: the wide layers' output columns split over the model axis.

Port of ``dhaug_tpu/parallel/mesh.py``'s ``shard_params_tp``,
``assert_model_sharded`` and ``place_state`` (``:129-176``).  The JAX
package shards every parameter and optimizer leaf whose last dimension is
at least ``TP_MIN_WIDTH`` and divides by the model axis M: flax Dense
kernels are (in, out) and conv kernels (k, in, out), so that is column
(output) parallelism of every wide layer, its bias and Adam moments
sharded alike, with GSPMD inserting the collectives.  The port does it by
hand: :func:`shard_module_tp` swaps each wide ``nn.Linear`` / ``nn.Conv1d``
for a :class:`ColumnParallelLinear` / :class:`ColumnParallelConv1d` that
keeps this rank's block of output rows of ``weight`` (dim 0 of torch's
(out, in[, k]) layout) and of ``bias``, and runs copy -> local product ->
gather.  Activations stay whole and the same on every rank of a model
group; optimizers built after the swap hold moments of the blocks only.

The four mappings are ``torch.autograd.Function``\\ s over the model group
whose backwards call their partner mapping's ``apply``: copy (identity;
backward all-reduce, which is reduce), reduce (all-reduce; backward copy),
gather along a feature axis (all-gather; backward this rank's slice, which
is scatter) and scatter (this rank's slice; backward gather).  So a
backward is itself differentiable, and the critics' gradient penalty
(``torch.autograd.grad(create_graph=True)``, ``gan/wgan.py``)
differentiates it a second time with collectives in the right places.

Layout differences from the JAX package, not of value: norm scales,
position embeddings and batch statistics stay whole here, where the JAX
rule also shards those whose last dimension is wide.  Checkpoints hold the
single-device layout: :func:`full_state_dict` / :func:`full_optimizer_state`
gather the blocks, :func:`local_state_dict` / :func:`local_optimizer_state`
cut them out again for the run that loads.
"""
from __future__ import annotations

import copy
from typing import List, Mapping

import torch
from torch import nn
from torch.nn import functional as F

from dhaug_torch.parallel import mesh

# Output widths >= this shard over the model axis; the production nets' wide
# layers are 512-1536 (PoseFormer) and 1000-1024 (GAN nets, MLP, VideoPose),
# the narrow glue layers (<= 100) stay whole.
TP_MIN_WIDTH = 512


def _axis() -> mesh.ModelAxis:
    return mesh.current().model


class _Copy(torch.autograd.Function):
    """Identity; the cotangent of a whole input is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g)


class _Reduce(torch.autograd.Function):
    """All-reduce (sum); the sum's cotangent is every term's."""

    @staticmethod
    def forward(ctx, x):
        return _axis().all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g)


class _Gather(torch.autograd.Function):
    """All-gather of the blocks along ``dim``; a block's cotangent is its
    slice of the whole one."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim = dim
        return _axis().all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _Scatter.apply(g, ctx.dim), None


class _Scatter(torch.autograd.Function):
    """This rank's block of a whole tensor along ``dim``; the whole one's
    cotangent is the blocks' gathered."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim = dim
        axis = _axis()
        n = x.shape[dim] // axis.world
        return x.narrow(dim, axis.rank * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.dim), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return _Copy.apply(x) if _axis().group is not None else x


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Gather.apply(x, dim) if _axis().group is not None else x


def _block(t: torch.Tensor, axis: mesh.ModelAxis) -> nn.Parameter:
    return nn.Parameter(t.detach()[axis.block(t.shape[0])].clone())


class ColumnParallelLinear(nn.Module):
    """An ``nn.Linear`` of which this rank holds a block of output rows:
    the input copied to the model group, the local product, the blocks
    gathered along the feature axis.  ``dtype`` is flax's compute dtype
    (``models/blocks.apply_dense``): input, weight block and bias block cast
    to it, the bias added to the product in it."""

    def __init__(self, layer: nn.Linear, axis: mesh.ModelAxis):
        super().__init__()
        self.in_features, self.out_features = layer.in_features, layer.out_features
        self.weight = _block(layer.weight, axis)
        self.bias = None if layer.bias is None else _block(layer.bias, axis)

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        x = copy_to_model(x)
        if dtype is None:
            y = F.linear(x, self.weight, self.bias)
        else:
            y = F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)
        return gather_from_model(y, -1)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features} "
                f"(block {self.weight.shape[0]})")


class ColumnParallelConv1d(nn.Module):
    """An ``nn.Conv1d`` of which this rank holds a block of output
    channels, gathered along the channel axis (dim 1 of (B, C, T))."""

    def __init__(self, layer: nn.Conv1d, axis: mesh.ModelAxis):
        super().__init__()
        if layer.groups != 1 or layer.padding_mode != "zeros":
            raise ValueError("column parallelism takes ungrouped, zero-padded convolutions")
        self.in_channels, self.out_channels = layer.in_channels, layer.out_channels
        self.kernel_size, self.stride = layer.kernel_size, layer.stride
        self.padding, self.dilation = layer.padding, layer.dilation
        self.weight = _block(layer.weight, axis)
        self.bias = None if layer.bias is None else _block(layer.bias, axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv1d(copy_to_model(x), self.weight, self.bias, self.stride, self.padding,
                     self.dilation)
        return gather_from_model(y, 1)

    def extra_repr(self) -> str:
        return (f"{self.in_channels}, {self.out_channels} (block {self.weight.shape[0]}), "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"dilation={self.dilation}")


_PARALLEL_OF = {nn.Linear: (ColumnParallelLinear, "out_features"),
                nn.Conv1d: (ColumnParallelConv1d, "out_channels")}
_COLUMN_PARALLEL = (ColumnParallelLinear, ColumnParallelConv1d)


def shard_module_tp(module: nn.Module, min_width: int = TP_MIN_WIDTH) -> int:
    """Swap, in place, every ``nn.Linear`` / ``nn.Conv1d`` of ``module``
    whose output width is at least ``min_width`` and divides by the model
    axis for its column-parallel twin, cut from the layer's (already
    initialized, whole) weights; returns how many were swapped.  Build the
    optimizer after this.  A model axis of one rank swaps nothing."""
    axis = _axis()
    if axis.world == 1:
        return 0
    swapped = 0
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            kind = _PARALLEL_OF.get(type(child))
            if kind is None:
                continue
            width = getattr(child, kind[1])
            if width >= min_width and width % axis.world == 0:
                setattr(parent, name, kind[0](child, axis))
                swapped += 1
    return swapped


def assert_model_sharded(*modules: nn.Module, what: str = "GAN net states") -> None:
    """Fail loudly when a model axis of more than one rank sharded no layer
    of ``modules`` (the JAX package's check and words): a
    ``--model_parallel_devices`` that divides no wide layer would otherwise
    replicate every net on M ranks for nothing.  Pass only nets that have
    wide layers (not the 128-wide SemGCN)."""
    axis = _axis()
    if axis.world == 1:
        return
    if any(isinstance(m, _COLUMN_PARALLEL) for module in modules for m in module.modules()):
        return
    raise SystemExit(
        f"--model_parallel_devices {axis.world} sharded no layer "
        f"of the {what}: no Dense width >= {TP_MIN_WIDTH} is divisible by "
        f"{axis.world}. Pick a divisor of Gen_DenseDim / "
        "Dis_DenseDim (defaults 1000) or drop --model_parallel_devices.")


def sharded_parameters(module: nn.Module) -> List[nn.Parameter]:
    """The parameters of ``module`` that hold a column block."""
    return [p for m in module.modules() if isinstance(m, _COLUMN_PARALLEL)
            for p in m.parameters(recurse=False)]


def _sharded_keys(module: nn.Module) -> List[str]:
    """The ``state_dict`` keys of the column blocks."""
    return [f"{prefix}.{name}" if prefix else name
            for prefix, m in module.named_modules() if isinstance(m, _COLUMN_PARALLEL)
            for name, _ in m.named_parameters(recurse=False)]


def full_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` in the single-device layout: each column
    block gathered over the model group.  Every rank of the group calls it."""
    sd = module.state_dict()
    axis = _axis()
    for key in _sharded_keys(module) if axis.world > 1 else ():
        sd[key] = axis.all_gather(sd[key], 0)
    return sd


def _cut(saved: torch.Tensor, local: torch.Tensor, axis: mesh.ModelAxis) -> torch.Tensor:
    """This rank's rows of a whole ``saved`` tensor; one whose rows do not
    make M blocks of ``local``'s is left whole, for the caller's shape check."""
    if saved.ndim == 0 or saved.shape[0] != local.shape[0] * axis.world:
        return saved
    return saved[axis.block(saved.shape[0])]


def local_state_dict(module: nn.Module, saved: Mapping[str, torch.Tensor]) -> dict:
    """A single-device ``state_dict`` cut to this rank's column blocks of
    ``module`` (no collective)."""
    axis = _axis()
    out = dict(saved)
    if axis.world > 1:
        own = module.state_dict()
        for key in _sharded_keys(module):
            if key in out and key in own:
                out[key] = _cut(out[key], own[key], axis)
    return out


def _indexed(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """{optimizer state index: the column-block parameter}, in the
    numbering ``Optimizer.state_dict`` gives its parameters."""
    blocks = {id(p) for p in sharded_parameters(module)}
    params = [p for group in opt.param_groups for p in group["params"]]
    return {i: p for i, p in enumerate(params) if id(p) in blocks}


def full_optimizer_state(opt: torch.optim.Optimizer, module: nn.Module) -> dict:
    """``opt.state_dict()`` of ``module``'s parameters in the single-device
    layout: the moments of each column block gathered over the model
    group.  Every rank of the group calls it."""
    sd = opt.state_dict()
    axis = _axis()
    if axis.world == 1:
        return sd
    for i, p in _indexed(opt, module).items():
        # a new dict: the packed state's dicts are the optimizer's own
        sd["state"][i] = {k: axis.all_gather(v, 0) if torch.is_tensor(v) and v.shape == p.shape
                          else v for k, v in sd["state"].get(i, {}).items()}
    return sd


def local_optimizer_state(opt: torch.optim.Optimizer, module: nn.Module,
                          saved: Mapping) -> dict:
    """A single-device optimizer ``state_dict`` cut to this rank's column
    blocks (no collective)."""
    axis = _axis()
    if axis.world == 1:
        return dict(saved)
    out = {"state": {i: dict(s) for i, s in saved["state"].items()},
           "param_groups": copy.deepcopy(saved["param_groups"])}
    for i, p in _indexed(opt, module).items():
        state = out["state"].get(i, {})
        for k, v in state.items():
            if torch.is_tensor(v) and v.ndim >= 1:
                state[k] = _cut(v, p, axis)
    return out

