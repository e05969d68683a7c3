"""The port's five posenets (dhaug_torch/models/posenets.py, factory.py,
convert.py) against the flax ones on the CPU: forward parity <= 1e-5 in eval
and train mode and for both temporal twins, BatchNorm running statistics
<= 1e-6 after one train-mode forward, and the round trip through
dhaug_tpu/utils/transplant.py, which reads the reference's state_dict names."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch.data.h36m import Human36mDataset as TorchH36m
from dhaug_torch.models import convert
from dhaug_torch.models import factory as t_factory
from dhaug_torch.models import posenets as t_pose
from dhaug_tpu.data.h36m import Human36mDataset as JaxH36m
from dhaug_tpu.models import factory as j_factory
from dhaug_tpu.models import posenets as j_pose
from dhaug_tpu.utils.transplant import transplant_posenet_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
STATS_TOL = 1e-6
B = 12


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def adj():
    skeleton = TorchH36m(os.path.join(REPO, "data", "data_3d_h36m.npz")).skeleton()
    return t_factory.adjacency_from_skeleton(skeleton)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# (name, architecture, strided): the multi-frame nets at "3" and "3,3", the
# temporal ones in both twins
CASES = [("mlp", None, True), ("gcn", None, True), ("videopose", None, True),
         ("mulit_farme_videopose", "3", True), ("mulit_farme_videopose", "3", False),
         ("mulit_farme_videopose", "3,3", True), ("mulit_farme_videopose", "3,3", False),
         ("mulit_farme_poseformer", "3", True), ("mulit_farme_poseformer", "3,3", True)]


def _pair(name, arch, strided, adj):
    """Small flax and port nets of one kind, dropout and drop-path 0."""
    if name == "mlp":
        return (j_pose.LinearModel(linear_size=48, num_stage=2, dropout=0.0),
                t_pose.LinearModel(linear_size=48, num_stage=2, p_dropout=0.0))
    if name == "gcn":
        return (j_pose.SemGCN(adj=adj, hid_dim=24, num_layers=2, dropout=0.0),
                t_pose.SemGCN(adj, hid_dim=24, num_layers=2, p_dropout=0.0))
    if name == "videopose":
        kw = dict(out_joints=15, pad_hip_joint=True, channels=40, strided=True)
        return (j_pose.TemporalPoseNet(filter_widths=(1, 1, 1), dropout=0.0, **kw),
                t_pose.TemporalPoseNet((1, 1, 1), p_dropout=0.0, **kw))
    widths = tuple(int(w) for w in arch.split(","))
    if name == "mulit_farme_videopose":
        kw = dict(out_joints=16, channels=40, strided=strided)
        return (j_pose.TemporalPoseNet(filter_widths=widths, dropout=0.0, **kw),
                t_pose.TemporalPoseNet(widths, p_dropout=0.0, **kw))
    kw = dict(num_frame=int(np.prod(widths)), embed_dim_ratio=16, depth=2, num_heads=4,
              drop_path_rate=0.0)
    return j_pose.PoseFormer(**kw), t_pose.PoseFormer(**kw)


def _inputs(name, arch, strided, seed):
    rng = np.random.default_rng(seed)
    if name in ("mlp", "gcn", "videopose"):
        shape = (B, 16, 2)
    else:
        rf = int(np.prod([int(w) for w in arch.split(",")]))
        # the dilated twin keeps every valid frame: give it 4 more
        shape = (B, rf + (0 if strided else 4), 16, 2)
    return (rng.normal(size=shape) * 0.4).astype(np.float32)


def _flax_trees(model, x, seed):
    """Initialized flax trees with every leaf perturbed (so BatchNorm's
    affine parameters and running statistics are not trivial)."""
    v = model.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                   jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(
        np.float32) * 0.1, v["params"])
    stats = jax.tree.map(lambda a: np.abs(np.asarray(a) + rng.normal(size=a.shape).astype(
        np.float32) * 0.1), v.get("batch_stats", {}))
    return params, stats


def _apply(model, params, stats, x, train):
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    if train:
        out, mutated = model.apply(variables, jnp.asarray(x), train=True,
                                   rngs={"dropout": jax.random.PRNGKey(0)},
                                   mutable=["batch_stats"])
        return np.asarray(out), _np_tree(mutated.get("batch_stats", {}))
    return np.asarray(model.apply(variables, jnp.asarray(x), train=False)), None


def _buffers(net):
    return {k: v.detach().numpy() for k, v in net.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,arch,strided", CASES)
def test_forward_parity(name, arch, strided, train, adj):
    jm, port = _pair(name, arch, strided, adj)
    x = _inputs(name, arch, strided, seed=3)
    params, stats = _flax_trees(jm, x, seed=4)
    convert.load_posenet(name, port, params, stats)
    ref, new_stats = _apply(jm, params, stats, x, train)
    port.train(train)
    out = port(torch.from_numpy(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    if train and stats:
        fresh = _pair(name, arch, strided, adj)[1]
        convert.load_posenet(name, fresh, params, new_stats)
        want, got = _buffers(fresh), _buffers(port)
        assert list(want) == list(got) and want
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=STATS_TOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name,arch,strided", CASES)
def test_transplant_round_trip(name, arch, strided, adj):
    """The port's state_dict carries the reference's names: the JAX
    package's transplant (the reader of reference .pth.tar files) maps it
    onto flax trees whose forward equals the port's, and convert.load_posenet
    of those trees gives the port's state_dict back bit for bit."""
    jm, port = _pair(name, arch, strided, adj)
    x = _inputs(name, arch, strided, seed=5)
    template, template_stats = _flax_trees(jm, x, seed=6)
    torch.manual_seed(7)
    for p in port.parameters():  # non-trivial values everywhere
        p.data.add_(torch.randn_like(p) * 0.1)
    for k, b in port.named_buffers():
        if k.endswith("running_var"):
            b.uniform_(0.5, 1.5)
        elif k.endswith("running_mean"):
            b.normal_(0.0, 0.1)
    state = {k: v.detach().numpy().copy() for k, v in port.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    params, stats = transplant_posenet_state_dict(name, state, template, template_stats)
    ref, _ = _apply(jm, params, stats, x, train=False)
    port.eval()
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), ref, atol=TOL,
                               rtol=0)
    back = convert.load_posenet(name, _pair(name, arch, strided, adj)[1], params, stats)
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back.state_dict()[k], v), k


def test_factory_matches_jax(adj):
    """Names, receptive fields, the SemGCN adjacency, and each factory net's
    parameter count and output shape at the factory's own widths."""
    assert t_factory.POSENET_NAMES == j_factory.POSENET_NAMES
    for arch in ("3", "3,3", "3,3,3", "1,1,1,1,1"):
        assert t_factory.receptive_field(arch) == j_factory.receptive_field(arch)
    j_skel = JaxH36m(os.path.join(REPO, "data", "data_3d_h36m.npz")).skeleton()
    np.testing.assert_array_equal(adj, j_pose.adjacency_from_skeleton(j_skel))
    t_skel = TorchH36m(os.path.join(REPO, "data", "data_3d_h36m.npz")).skeleton()
    for name in t_factory.POSENET_NAMES:
        for flag in ("train", "test"):
            jm = j_factory.make_posenet(name, stages=1, architecture="3", skeleton=j_skel,
                                        flag=flag)
            tm = t_factory.make_posenet(name, stages=1, architecture="3", skeleton=t_skel,
                                        flag=flag)
            ex = j_factory.example_input(name, batch=2, architecture="3")
            shapes = jax.eval_shape(lambda: j_factory.init_posenet(
                jm, jax.random.PRNGKey(0), ex)[0])
            n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
            assert sum(p.numel() for p in tm.parameters()) == n_jax, (name, flag)
            t_ex = t_factory.example_input(name, batch=2, architecture="3")
            assert tuple(t_ex.shape) == tuple(ex.shape)
            tm.eval()
            with torch.no_grad():
                out = tm(t_ex)
            assert out.shape == (2, 16, 3) if name in t_factory.SINGLE_FRAME_NAMES \
                else out.shape == (2, 1, 16, 3)
    with pytest.raises(ValueError, match="needs a skeleton"):
        t_factory.make_posenet("gcn")
    with pytest.raises(ValueError, match="invalid"):
        t_factory.make_posenet("resnet")


@pytest.mark.parametrize("name", t_factory.POSENET_NAMES)
def test_dropout_draws_from_the_generator(name, adj):
    """Train-mode dropout and drop-path come from the torch.Generator passed
    to forward: one seed gives one output, another seed another."""
    skeleton = TorchH36m(os.path.join(REPO, "data", "data_3d_h36m.npz")).skeleton()
    torch.manual_seed(0)
    net = t_factory.make_posenet(name, stages=1, dropout=0.5, architecture="3",
                                 skeleton=skeleton)
    x = t_factory.example_input(name, batch=6, architecture="3").normal_()

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return net(x, g).detach()

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_semgcn_support_weights_are_exact_zeros_off_the_graph(adj):
    conv = t_pose.SemGraphConv(4, 3, adj)
    with torch.no_grad():
        conv.e.normal_()
    x = torch.randn(5, 16, 4)
    out = conv(x)
    # a joint's output depends only on itself and its graph neighbours
    x2 = x.clone()
    far = [j for j in range(16) if adj[0, j] == 0]
    x2[:, far] += 100.0
    torch.testing.assert_close(conv(x2)[:, 0], out[:, 0], rtol=0, atol=0)


def test_convert_rejects_mismatched_trees(adj):
    jm, port = _pair("gcn", None, True, adj)
    params, stats = _flax_trees(jm, _inputs("gcn", None, True, 0), seed=0)
    with pytest.raises(ValueError, match="shape"):
        convert.load_posenet("gcn", t_pose.SemGCN(adj, hid_dim=25, num_layers=2), params,
                             stats)
    with pytest.raises(ValueError, match="expected"):
        convert.load_posenet("gcn", t_pose.SemGCN(adj, hid_dim=24, num_layers=3), params,
                             stats)
    with pytest.raises(ValueError, match="unknown posenet"):
        convert.load_posenet("resnet", port, params, stats)
