"""The generator trunk for inference (dhaug_torch/models/trunk_cuda.py):
its operands and its plain bf16 version, held to the JAX package's
``trunk_reference_bf16`` and to the Pallas kernel in interpret mode.

Tolerances, relative to the standard deviation of the head:

* port vs JAX: both take exact bf16 x bf16 products and sum them in fp32,
  in different orders, so they are held to ``trunk_cuda.TRUNK_MAX_ERR``
  (max) and ``TRUNK_MEAN_ERR`` (mean), the rule the kernel meets on the
  card; its reasons are beside the constants.  At D = 64 and 40 no bf16
  rounding flips (at most 5.3e-7); at the full width D = 1000 they do
  (0.0115 / 2.2e-4 at B = 1024).
* plain bf16 trunk vs the fp32 ``FkGeneratorNet``: the JAX package's own
  bound for its bf16 trunk, 0.05 (tests/test_fk_pallas.py:83-91);
  measured 0.018-0.023 here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhaug_torch.models import convert, trunk_cuda
from dhaug_torch.models.generator import FkGeneratorNet, GeneratorConfig
from dhaug_tpu.models import generator as j_gen
from dhaug_tpu.models.trunk_pallas import trunk_forward_pallas, trunk_reference_bf16

BF16_VS_FP32 = 0.05


def _nets(dense, seed=0):
    net = j_gen.FkGeneratorNet(j_gen.GeneratorConfig(dense_dim=dense))
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((2, 128)))["params"]
    port = convert.load_generator(FkGeneratorNet(GeneratorConfig(dense_dim=dense)),
                                  jax.tree.map(np.asarray, params))
    return net, params, port


def _noise(B, seed=1):
    return np.random.default_rng(seed).normal(size=(B, 128)).astype(np.float32)


def _unpadded_operands(port):
    """The operands in trunk_weights' order with no padding."""
    layers = ([port.prelude.fc] + [fc for blk in port.blocks for fc in (blk.fc1, blk.fc2)]
              + [port.head])
    return tuple(t for layer in layers
                 for t in (layer.weight.detach().to(torch.bfloat16), layer.bias.detach()))


@pytest.mark.parametrize("dense,B", [(64, 100), (64, 7), (40, 100), (1000, 1024)])
def test_plain_trunk_matches_jax_reference_and_pallas_kernel(dense, B):
    _, params, port = _nets(dense)
    noise = _noise(B)
    ops = trunk_cuda.trunk_weights(port)
    out = trunk_cuda.trunk_reference_bf16(ops, torch.from_numpy(noise)).numpy()
    ref = np.array(trunk_reference_bf16(params, jnp.asarray(noise)))
    kernel = np.array(trunk_forward_pallas(params, jnp.asarray(noise), interpret=True))
    assert out.shape == (B, 35)
    for oracle in (ref, kernel):
        max_err, mean_err = trunk_cuda.trunk_errors(torch.from_numpy(out),
                                                    torch.from_numpy(oracle))
        assert max_err <= trunk_cuda.TRUNK_MAX_ERR and mean_err <= trunk_cuda.TRUNK_MEAN_ERR


def _kernel_storage_model(ops, noise):
    """Plain model of kernel B3's data flow between its 8 launches: the
    prelude stores h in fp32 and its bf16 shadow; layer a of each block
    stores y in bf16 only; layer b reads y and the fp32 h, and stores the
    new fp32 h (not in the last block, where nothing reads it) and its
    shadow; the head reads the shadow.  Each layer multiplies bf16
    operands, sums in fp32 and adds the fp32 bias (then the residual)."""
    def layer(a_bf16, w, b):
        return a_bf16.float() @ w.float().t() + b

    h = torch.relu(layer(noise.float().to(torch.bfloat16), ops[0], ops[1]))
    shadow = h.to(torch.bfloat16)
    for i in range(3):
        wa, ba, wb, bb = ops[2 + 4 * i: 6 + 4 * i]
        y = torch.relu(layer(shadow, wa, ba)).to(torch.bfloat16)
        new_h = torch.relu(layer(y, wb, bb) + h)
        shadow = new_h.to(torch.bfloat16)
        h = new_h if i < 2 else None
    return layer(shadow, ops[-2], ops[-1])


@pytest.mark.parametrize("dense", [40, 64, 1000])
def test_bf16_storage_between_layers_changes_nothing(dense):
    """Storing each activation in bf16 where its next reader rounds it to
    bf16 anyway gives the plain version's result bit for bit."""
    _, _, port = _nets(dense)
    ops = trunk_cuda.trunk_weights(port)
    noise = torch.from_numpy(_noise(96, seed=5))
    assert torch.equal(_kernel_storage_model(ops, noise),
                       trunk_cuda.trunk_reference_bf16(ops, noise))


def test_plain_trunk_tracks_the_fp32_net():
    _, _, port = _nets(128)
    noise = torch.from_numpy(_noise(300, seed=2))
    out = trunk_cuda.trunk_reference_bf16(trunk_cuda.trunk_weights(port), noise)
    with torch.no_grad():
        ref = port(noise)
    assert float((out - ref).abs().max()) < BF16_VS_FP32 * float(ref.std())


def test_tolerance_rule_rejects_a_truncating_cast(monkeypatch):
    """The rule is tight enough to catch a kernel that truncates its
    activations to bf16 instead of rounding them to nearest even (measured
    0.069 / 0.013 here, against 0.03 / 2e-3)."""
    _, _, port = _nets(128)
    ops = trunk_cuda.trunk_weights(port)
    noise = torch.from_numpy(_noise(300, seed=4))
    ref = trunk_cuda.trunk_reference_bf16(ops, noise)

    def truncating_mm(x, w):
        x16 = (x.float().contiguous().view(torch.int32) & -65536).view(torch.float32)
        return x16 @ w.float().t()

    monkeypatch.setattr(trunk_cuda, "_mm", truncating_mm)
    max_err, mean_err = trunk_cuda.trunk_errors(trunk_cuda.trunk_reference_bf16(ops, noise), ref)
    assert max_err > trunk_cuda.TRUNK_MAX_ERR and mean_err > trunk_cuda.TRUNK_MEAN_ERR


def test_operands_layout_and_padding():
    _, params, port = _nets(40)
    ops = trunk_cuda.trunk_weights(port)
    assert len(ops) == trunk_cuda.N_OPERANDS
    shapes = [(64, 128), (64,)] + [(64, 64), (64,)] * 6 + [(35, 64), (35,)]
    assert [tuple(t.shape) for t in ops] == shapes
    assert [t.dtype for t in ops] == [torch.bfloat16, torch.float32] * 8
    # bf16 weights round to nearest even exactly as astype(jnp.bfloat16)
    w0 = np.asarray(jnp.asarray(params["DensePrelude_0"]["Dense_0"]["kernel"], jnp.bfloat16)
                    .astype(jnp.float32)).T
    np.testing.assert_array_equal(ops[0][:40].float().numpy(), w0)
    # padded rows, columns and bias entries are exactly 0
    for w, b in zip(ops[0::2], ops[1::2]):
        assert not w[40:].any() and not b[40:].any()
        if w.shape[1] == 64:
            assert not w[:, 40:].any()


def test_padded_operands_give_the_unpadded_result():
    _, _, port = _nets(40)
    noise = torch.from_numpy(_noise(33, seed=3))
    padded = trunk_cuda.trunk_reference_bf16(trunk_cuda.trunk_weights(port), noise)
    plain = trunk_cuda.trunk_reference_bf16(_unpadded_operands(port), noise)
    # zero padding adds exact zeros to every sum
    assert torch.equal(padded, plain)


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    _, _, port = _nets(40)
    ops = trunk_cuda.trunk_weights(port)
    noise = torch.from_numpy(_noise(5))
    n0 = trunk_cuda.TRUNK_LAUNCHES
    torch.testing.assert_close(trunk_cuda.trunk_forward(ops, noise),
                               trunk_cuda.trunk_reference_bf16(ops, noise), atol=0, rtol=0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trunk_cuda.trunk_forward_cuda(ops, noise)
    assert trunk_cuda.TRUNK_LAUNCHES == n0
