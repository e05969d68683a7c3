"""The generator trunk for inference: kernel B3 and its plain version.

Counterpart of ``dhaug_tpu/models/trunk_pallas.py``.  The trunk of
:class:`~dhaug_torch.models.generator.FkGeneratorNet` (Dense 128 -> D +
ReLU, 3 residual blocks of two D x D layers, head D -> 35) is computed
with bf16 x bf16 products, fp32 accumulation and fp32 bias and residual
adds: the precision of the TPU kernel and of XLA's default matmul there.

* :func:`trunk_weights` -- the kernel's operands, prepared once from a net.
* :func:`trunk_reference_bf16` -- the plain PyTorch version (CPU path,
  tests, and the kernel's yardstick on the card).
* :func:`trunk_forward_cuda` -- the wrapper of kernel B3
  (``csrc/trunk_kernels.cu``, built by ``ops/cuda_lib.py``): one
  persistent, warp-specialized ``wgmma`` GEMM a layer, fed by TMA, whose
  two consumer warpgroups mostly take tiles in turn so that one's epilogue
  runs under the other's wgmmas, and whose epilogue stores every
  activation that the next layer rounds to bf16 as bf16, through shared
  memory and TMA (bound: operations, 0.102 ms at B = 8192, D = 1000 on an
  H100; the design is noted at the top of the ``.cu`` file).
* :func:`trunk_forward` -- CPU tensors to the plain version, CUDA tensors
  to the kernel or an error.  There is no fallback.

On the CPU the port synthesizes with this bf16 trunk too (the JAX CLI off
the TPU uses its fp32 flax trunk instead), so the CPU and the card compute
the function the TPU path computes.

``TRUNK_LAUNCHES`` counts calls of the kernel's launcher: one per trunk
call, which makes 8 device launches (one per layer).  ``TRUNK_TILES`` and
``TRUNK_BLOCKS`` are the 64-row output tiles and the blocks of each
residual block's layer b in the last call that launched: more tiles than
blocks means each block walked several tiles.
"""
from __future__ import annotations

import ctypes

import torch

from dhaug_torch.models.generator import FkGeneratorNet
from dhaug_torch.ops import cuda_lib

TRUNK_LAUNCHES = 0
TRUNK_TILES = 0
TRUNK_BLOCKS = 0
# every K and the hidden width are zero-padded to a multiple of this: the
# kernel steps K by 64, one 128-byte row of its swizzled bf16 tiles
PAD = 64
# the prelude stages the whole fp32 noise row in its 4 ring stages of 64;
# the head is one 48-wide tile
MAX_NOISE_WIDTH = 256
MAX_HEAD_WIDTH = 48
N_OPERANDS = 16

_LIB = None

# How closely two computations of this bf16 trunk agree when their fp32
# sums run in different orders (kernel vs plain version on the card, port
# vs JAX on the CPU), as max and mean absolute error over the standard
# deviation of the head.  A last-bit difference of a sum can flip the bf16
# rounding of an activation that the next layer multiplies, so agreement is
# bf16-level on some elements, not bitwise.  Measured at D = 1000: kernel
# vs plain on an H100 0.0137 / 5.5e-4 at B = 8192 (chip_smoke.py), port vs
# JAX on the CPU 0.0115 / 2.2e-4 at B = 1024 (tests/test_torch_trunk.py).
# A systematic fault moves the mean by the size of bf16 rounding or more:
# truncating the activations instead of rounding them gives 0.069 / 0.013
# (tests/test_torch_trunk.py).  The max stays under the JAX package's 0.05
# bound for its bf16 trunk against fp32 (tests/test_fk_pallas.py:83-91).
TRUNK_MAX_ERR = 0.03
TRUNK_MEAN_ERR = 2e-3


def trunk_errors(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max, mean) absolute error of ``got`` over the standard deviation of
    ``ref``, to hold against TRUNK_MAX_ERR and TRUNK_MEAN_ERR."""
    err = (got.float() - ref.float()).abs()
    scale = float(ref.float().std())
    return float(err.max()) / scale, float(err.mean()) / scale


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


@torch.no_grad()
def trunk_weights(net: FkGeneratorNet) -> tuple:
    """The trunk's operands in the kernel's order: w0, b0, then wa, ba, wb,
    bb for each of the 3 residual blocks, then wh, bh, on the net's device.

    Weights are bf16 (round to nearest even, as ``astype(jnp.bfloat16)``)
    in nn.Linear's (out, in) layout; biases are fp32 (out,).  Every input
    width and the hidden width D are zero-padded to a multiple of ``PAD``,
    weights and biases alike, so padded activation columns stay exactly 0;
    the head keeps its 35 rows, and the kernel masks them.

    The operands are a copy of the weights as they are now: prepare them
    once after the weights are loaded, and again after any change to them,
    or they go stale."""
    hidden = [net.prelude.fc] + [fc for blk in net.blocks for fc in (blk.fc1, blk.fc2)]
    d_pad = _pad_to(net.prelude.fc.out_features, PAD)
    ops = []
    for layer in hidden + [net.head]:
        n_out, k_in = layer.weight.shape
        n_pad = n_out if layer is net.head else d_pad
        w = layer.weight.new_zeros(n_pad, _pad_to(k_in, PAD))
        w[:n_out, :k_in] = layer.weight
        b = layer.bias.new_zeros(n_pad)
        b[:n_out] = layer.bias
        ops += [w.to(torch.bfloat16).contiguous(), b.float().contiguous()]
    return tuple(ops)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # products of two bf16 values are exact in fp32, so this is the bf16
    # product with an fp32 sum
    return x.to(torch.bfloat16).float() @ w.float().t()


def trunk_reference_bf16(ops, noise: torch.Tensor) -> torch.Tensor:
    """The plain version: noise (B, 128) -> head (B, 35) fp32 with the
    kernel's cast pattern (bf16 operands, fp32 sums, bias and residual)."""
    h = torch.relu(_mm(noise.float(), ops[0]) + ops[1])
    for i in range(3):
        wa, ba, wb, bb = ops[2 + 4 * i: 6 + 4 * i]
        y = torch.relu(_mm(h, wa) + ba)
        h = torch.relu(_mm(y, wb) + bb + h)
    return _mm(h, ops[-2]) + ops[-1]


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("trunk_kernels")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dhtrunk_forward.argtypes = [ctypes.POINTER(vp), vp, vp, vp, vp, vp,
                                        ci, ci, ci, ci, vp]
        lib.dhtrunk_forward.restype = ci
        lib.dhtrunk_schedule.argtypes = [ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
        lib.dhtrunk_schedule.restype = ci
        lib.dhtrunk_error_string.argtypes = [ci]
        lib.dhtrunk_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def trunk_forward_cuda(ops, noise: torch.Tensor) -> torch.Tensor:
    """B3 on the card: ``ops`` from :func:`trunk_weights` (hidden width a
    multiple of 64), noise (B, K0) fp32 -> head (B, 35) fp32.  One call
    makes 8 device launches (one per layer) on the current stream, adds
    1 to ``TRUNK_LAUNCHES`` and sets ``TRUNK_TILES`` and ``TRUNK_BLOCKS``.
    Scratch: h in fp32 (the residual), its bf16 shadow and y in bf16, each
    (B, D)."""
    global TRUNK_LAUNCHES, TRUNK_TILES, TRUNK_BLOCKS
    device = noise.device
    if device.type != "cuda":
        raise ValueError(f"trunk_forward_cuda needs CUDA tensors, got {device}")
    if len(ops) != N_OPERANDS:
        raise ValueError(f"expected {N_OPERANDS} trunk operands, got {len(ops)}")
    if noise.dim() != 2:
        raise ValueError(f"noise: shape {tuple(noise.shape)}, expected (B, K0)")
    B, k0 = noise.shape
    d, o = ops[0].shape[0], ops[-2].shape[0]
    if k0 % PAD or d % PAD or k0 > MAX_NOISE_WIDTH or o > MAX_HEAD_WIDTH:
        raise ValueError(f"noise width {k0} and hidden width {d} must be multiples of {PAD}, "
                         f"the noise width at most {MAX_NOISE_WIDTH} and the head width {o} "
                         f"at most {MAX_HEAD_WIDTH} (prepare the operands with trunk_weights)")
    shapes = [(d, k0), (d,)] + [(d, d), (d,)] * 6 + [(o, d), (o,)]
    for i, (t, shape) in enumerate(zip(ops, shapes)):
        dtype = torch.bfloat16 if i % 2 == 0 else torch.float32
        cuda_lib.check_tensor(f"operand {i}", t, shape, dtype, device, align=16)
    cuda_lib.check_tensor("noise", noise, (B, k0), torch.float32, device, align=16)
    out = torch.empty((B, o), dtype=torch.float32, device=device)
    if B == 0:
        return out
    h = torch.empty((B, d), dtype=torch.float32, device=device)
    hs = torch.empty((B, d), dtype=torch.bfloat16, device=device)
    y = torch.empty((B, d), dtype=torch.bfloat16, device=device)
    params = (ctypes.c_void_p * N_OPERANDS)(*[t.data_ptr() for t in ops])
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.dhtrunk_forward(params, noise.data_ptr(), h.data_ptr(), hs.data_ptr(),
                                 y.data_ptr(), out.data_ptr(), B, k0, d, o, stream)
        cuda_lib.raise_on(lib.dhtrunk_error_string, rc, "trunk_gemm_kernel")
        tiles, blocks = ctypes.c_int(), ctypes.c_int()
        rc = lib.dhtrunk_schedule(B, d, ctypes.byref(tiles), ctypes.byref(blocks))
    cuda_lib.raise_on(lib.dhtrunk_error_string, rc, "trunk_gemm_kernel")
    TRUNK_LAUNCHES += 1
    TRUNK_TILES, TRUNK_BLOCKS = tiles.value, blocks.value
    return out


def trunk_forward(ops, noise: torch.Tensor) -> torch.Tensor:
    """Head (B, 35) from noise (B, 128): the plain version for CPU
    tensors, kernel B3 for CUDA tensors."""
    if noise.device.type == "cpu":
        return trunk_reference_bf16(ops, noise)
    return trunk_forward_cuda(ops, noise)
