"""Worker functions of the tensor-parallel tests (tests/test_torch_tp.py,
tests/test_torch_tp_cli.py), in a module that the ranks' spawned processes
import by name.  It holds no test.

:func:`run` runs a worker function of tests/test_torch_dp_worker.py with
the wide layers of every net it builds (output width >= ``MIN_WIDTH``)
column-parallel over the model axis (``parallel/tensor.shard_module_tp``)
and every weight it returns gathered to the single-device layout, so a
result of a (1, 2) or (2, 2) rank grid compares directly with the
one-process one.  The other functions are the checks of this slice's own:
the gradient penalty's parameter gradients, the clipped global norm, the
column blocks' sizes, the bf16 trunk, snapshots written and read on a
grid, and the video CLI with narrow posenets.  Imports torch, numpy and
dhaug_torch only (no JAX)."""
import contextlib
import types

import torch

import test_torch_dp_worker as dpw
from dhaug_torch.models import discriminators, generator, posenets
from dhaug_torch.parallel import mesh
from dhaug_torch.parallel.tensor import (full_state_dict, shard_module_tp,
                                         sharded_parameters)
from dhaug_torch.train.state import adam_gan, clip_by_global_norm
from dhaug_torch.utils import checkpoint

# the JAX package's tests shard their width-32 nets with min_width 16
# (tests/test_parallel.py:210-212)
MIN_WIDTH = 16


def _host(x):
    return x.detach().cpu().numpy()


def full_state(module):
    return {k: _host(v) for k, v in full_state_dict(module).items()}


def _whole(net, tensors):
    """``tensors`` ({parameter name of ``net``: tensor}) as numpy arrays,
    each column block gathered over the model group."""
    blocks = {id(p) for p in sharded_parameters(net)}
    axis = mesh.current().model
    return {k: _host(axis.all_gather(tensors[k], 0) if id(p) in blocks else tensors[k])
            for k, p in net.named_parameters()}


def sharded(module):
    shard_module_tp(module, MIN_WIDTH)
    return module


@contextlib.contextmanager
def _tensor_parallel():
    """tests/test_torch_dp_worker.py with its nets sharded as they are
    built and its weights gathered as they are returned."""
    saved = dpw.gan_nets, dpw._state, dpw.posenets
    shim = types.SimpleNamespace(
        LinearModel=lambda *a, **k: sharded(posenets.LinearModel(*a, **k)),
        TemporalPoseNet=lambda *a, **k: sharded(posenets.TemporalPoseNet(*a, **k)))
    dpw.gan_nets = lambda *a, **k: [sharded(n) for n in saved[0](*a, **k)]
    dpw._state, dpw.posenets = full_state, shim
    try:
        yield
    finally:
        dpw.gan_nets, dpw._state, dpw.posenets = saved


def run(fn: str, *args):
    """``tests/test_torch_dp_worker.<fn>(*args)`` on tensor-parallel nets,
    with this rank's model index beside."""
    with _tensor_parallel():
        out = getattr(dpw, fn)(*args)
    out["model_rank"] = mesh.current().model.rank
    return out


def critic_nets(width, frames, sds=None):
    """The four critics at ``width`` (the motion ones on clips of
    ``frames``), seeded or loaded from ``sds``, sharded."""
    torch.manual_seed(0)
    nets = [discriminators.Fk3DDiscriminator(width), discriminators.Fk2DDiscriminator(width),
            discriminators.MotionFk3DDiscriminator(frames, width),
            discriminators.MotionFk2DDiscriminator(frames, width)]
    if sds is not None:
        nets = [dpw.load_state(n, sd) for n, sd in zip(nets, sds)]
    return [sharded(n) for n in nets]


def gradient_penalty_grads(width, frames, sds, reals, fakes, alphas, lambda_gp):
    """Each critic's gradient-penalty term of ``wgan.critic_step`` alone,
    lambda * mean((|d score / d interp| - 1)^2), and its gradient with
    respect to every parameter: the penalty's input gradient comes from
    ``autograd.grad(create_graph=True)``, so the parameter gradient is a
    second differentiation through the tensor-parallel layers' backward.
    Returns the penalties and the gradients in the single-device layout."""
    out = {"gp": [], "grads": []}
    for net, real, fake, alpha in zip(critic_nets(width, frames, sds), reals, fakes, alphas):
        real, fake, alpha = (torch.as_tensor(x) for x in (real, fake, alpha))
        interp = (alpha * real + (1 - alpha) * fake).requires_grad_(True)
        (g,) = torch.autograd.grad(net(interp).sum(), interp, create_graph=True)
        norms = torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1) + 1e-12)
        gp = torch.mean((norms - 1.0) ** 2) * lambda_gp
        params = dict(net.named_parameters())
        grads = torch.autograd.grad(gp, list(params.values()), allow_unused=True)
        out["gp"].append(float(gp.detach()))
        out["grads"].append(_whole(net, {k: torch.zeros_like(p) if g is None else g
                                         for (k, p), g in zip(params.items(), grads)}))
    return out


def clipped_norm(width, x, y, max_norm):
    """The MLP posenet's global gradient norm and clipped gradients
    (``train/state.clip_by_global_norm``) after one MSE backward, the
    gradients gathered."""
    torch.manual_seed(0)
    mlp = sharded(posenets.LinearModel(linear_size=width, num_stage=2, p_dropout=0.0))
    loss = torch.mean((mlp(torch.as_tensor(x)) - torch.as_tensor(y)) ** 2)
    loss.backward()
    norm = clip_by_global_norm(mlp.parameters(), max_norm, sharded_parameters(mlp))
    return {"norm": float(norm),
            "grads": _whole(mlp, {k: p.grad for k, p in mlp.named_parameters()})}


def block_sizes(width):
    """{net: {parameter: (elements of weight, bias and Adam moments on this
    rank, elements of the whole parameter)}} after one Adam step of the
    GAN nets and the posenets at ``width``."""
    torch.manual_seed(0)
    nets = {"gen": generator.FkGeneratorNet(generator.GeneratorConfig(dense_dim=width)),
            "d3d": discriminators.Fk3DDiscriminator(width),
            "d2d": discriminators.Fk2DDiscriminator(width),
            "mlp": posenets.LinearModel(linear_size=width, num_stage=1),
            "videopose": posenets.TemporalPoseNet((3, 3), channels=width),
            "poseformer": posenets.PoseFormer(num_frame=3, embed_dim_ratio=width // 16,
                                              depth=1, num_heads=2)}
    whole = {name: {k: p.numel() for k, p in net.named_parameters()}
             for name, net in nets.items()}
    out = {}
    for name, net in nets.items():
        sharded(net)
        opt = adam_gan(net.parameters())
        for p in net.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
        blocks = {id(p) for p in sharded_parameters(net)}
        out[name] = {k: {"param": p.numel(), "whole": whole[name][k],
                         "moments": [v.numel() for v in opt.state[p].values() if v.ndim],
                         "sharded": id(p) in blocks}
                     for k, p in net.named_parameters()}
    return out


def snapshot(width, directory, fmt):
    """The GAN nets at ``width`` after one Adam step on a seeded loss,
    sharded, written as a full-state snapshot (``checkpoint.net_state``)
    in ``fmt`` under ``directory``; returns the path and this rank's
    blocks of the weights and moments."""
    torch.manual_seed(0)
    nets = dpw.gan_nets(width, 1, None)
    for n in nets:
        sharded(n)
    opts = [adam_gan(n.parameters()) for n in nets]
    for net, opt in zip(nets, opts):
        for p in net.parameters():
            p.grad = torch.full_like(p, 0.5) + 0.01 * torch.arange(p.numel()).reshape(p.shape)
        opt.step()
    state = {"epoch": 0, "best": None,
             **{f"net{i}": checkpoint.net_state(n, o) for i, (n, o) in enumerate(zip(nets, opts))}}
    path = checkpoint.save_snapshot(state, directory, "resume_latest", fmt)
    mesh.current().barrier()
    return {"path": path, "local": [_local(n, o) for n, o in zip(nets, opts)]}


def _local(net, opt):
    return {"model": {k: _host(v) for k, v in net.state_dict().items()},
            "opt": {i: {k: _host(v) for k, v in s.items()}
                    for i, s in enumerate(opt.state[p] for p in net.parameters())}}


def restore(width, path):
    """The GAN nets at ``width``, sharded, restored from the snapshot at
    ``path`` (``checkpoint.restore_net``); returns this rank's blocks."""
    saved = checkpoint.load_snapshot(path)
    nets = [sharded(n) for n in dpw.gan_nets(width, 1, None)]
    opts = [adam_gan(n.parameters()) for n in nets]
    for i, (n, o) in enumerate(zip(nets, opts)):
        checkpoint.restore_net(n, o, saved[f"net{i}"])
    return {"local": [_local(n, o) for n, o in zip(nets, opts)]}


def bf16_generator(width, noise):
    """The bf16-trunk generator's head (``--bf16_trunk``) on ``noise``."""
    torch.manual_seed(0)
    cfg = generator.GeneratorConfig(dense_dim=width, bf16_trunk=True)
    gen = sharded(generator.FkGeneratorNet(cfg))
    head = gen(torch.as_tensor(noise))
    head.sum().backward()
    return {"head": _host(head),
            "grads": _whole(gen, {k: p.grad for k, p in gen.named_parameters()})}


def narrow_video_cli(argv):
    """``run_fk_gan.main(argv)`` on this rank with the multi-frame posenets
    at tests/test_torch_cli.py's CPU widths; global rank 0 returns its
    scores, epoch scalars and run directory, the others their kernel
    launches."""
    from dhaug_torch import run_fk_gan
    from dhaug_torch.train import video_runner
    from test_torch_cli import _narrow_posenet
    video_runner.make_posenet = _narrow_posenet
    out = run_fk_gan.main(argv)
    if not mesh.current().is_main:
        return {"launches": mesh.kernel_launches()}
    return {k: out[k] for k in ("scores", "epoch_scalars", "run_dir")}
