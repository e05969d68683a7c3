"""Kernel B3's index math (dhaug_torch/csrc/trunk_sm90.cuh), built for the
host with g++, against a Python model: the 128-byte swizzle that TMA
writes, the wgmma shared-memory descriptor, wgmma's accumulator layout and
the epilogue's two lane exchanges.

The kernel itself runs only on the card; these are the parts of it whose
mistakes would give wrong numbers with no error there.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from dhaug_torch.ops.cuda_lib import CSRC

_HOST = r"""
#include "trunk_sm90.cuh"
using namespace dhtrunk;
extern "C" void swizzle_offsets(int rows, unsigned* out) {
  for (int r = 0; r < rows; ++r)
    for (int b = 0; b < 128; ++b) out[r * 128 + b] = sw128_offset(r, b);
}
extern "C" unsigned long long descriptor(unsigned addr) { return sw128_desc(addr); }
extern "C" void acc_layout(int n, int* rows, int* cols) {
  for (int t = 0; t < 128; ++t)
    for (int i = 0; i < n / 2; ++i) {
      rows[t * (n / 2) + i] = acc_row(t, i);
      cols[t * (n / 2) + i] = acc_col(t, i);
    }
}
// the epilogue on a 64 x n tile held in wgmma's layout, with __shfl_xor_sync
// played by reading the partner lane's sent values: for each thread and
// column group j, the 4 floats exchange 1 leaves it; for each pair of
// groups, the 4 words exchange 2 leaves it (words are 32-bit codes here)
extern "C" void exchanges(const float* tile, int n, float* rows_out, unsigned* groups_out) {
  const int groups = n / 8;
  static float sent[128][2];
  static unsigned sent2[128][2];
  static float held[128][64][4];
  for (int j = 0; j < groups; ++j) {
    float x[128][4];
    for (int t = 0; t < 128; ++t) {
      for (int e = 0; e < 4; ++e) x[t][e] = tile[acc_row(t, 4 * j + e) * n + acc_col(t, 4 * j + e)];
      halves_send(x[t], (t & 31) & 1, sent[t]);
    }
    for (int t = 0; t < 128; ++t) {
      halves_take(x[t], sent[t ^ 1], (t & 31) & 1, held[t][j]);
      for (int e = 0; e < 4; ++e) rows_out[(t * groups + j) * 4 + e] = held[t][j][e];
    }
  }
  for (int jj = 0; jj < groups / 2; ++jj) {
    unsigned x[128][4];
    for (int t = 0; t < 128; ++t) {
      for (int h = 0; h < 2; ++h)
        for (int w = 0; w < 2; ++w) {
          // code of the word's first column: row * 4096 + column
          x[t][2 * h + w] = paired_row(t) * 4096u + paired_col(t, 2 * jj + h) + 2 * w;
        }
      halves_send(x[t], ((t & 31) & 2) != 0, sent2[t]);
    }
    for (int t = 0; t < 128; ++t) {
      unsigned g[4];
      halves_take(x[t], sent2[t ^ 2], ((t & 31) & 2) != 0, g);
      for (int e = 0; e < 4; ++e) groups_out[(t * (groups / 2) + jj) * 4 + e] = g[e];
    }
  }
}
extern "C" void paired(int n, int* rows, int* cols) {
  for (int t = 0; t < 128; ++t) {
    rows[t] = paired_row(t);
    for (int j = 0; j < n / 8; ++j) cols[t * (n / 8) + j] = paired_col(t, j);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel's index math needs it")
    build = tmp_path_factory.mktemp("trunk_host")
    src = build / "trunk_host.cpp"
    src.write_text(_HOST)
    path = build / "libtrunk_host.so"
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-std=c++17", "-D__host__=",
                    "-D__device__=", f"-I{CSRC}", str(src), "-o", str(path)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.swizzle_offsets.argtypes = [ci, vp]
    lib.descriptor.argtypes = [ctypes.c_uint]
    lib.descriptor.restype = ctypes.c_ulonglong
    lib.acc_layout.argtypes = [ci, vp, vp]
    lib.exchanges.argtypes = [vp, ci, vp, vp]
    lib.paired.argtypes = [ci, vp, vp]
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _tma_swizzle_128b(row: int, b: int) -> int:
    """Python model of CU_TENSOR_MAP_SWIZZLE_128B on a 1024-byte-aligned
    tile: address bits 4-6 (the 16-byte chunk) are XORed with bits 7-9
    (the row mod 8) of the unswizzled offset."""
    plain = row * 128 + b
    return plain ^ (((plain >> 7) & 7) << 4)


@pytest.mark.parametrize("rows", [8, 64, 128, 256])
def test_swizzle_matches_the_tma_pattern_and_is_a_permutation(lib, rows):
    out = np.zeros((rows, 128), np.uint32)
    lib.swizzle_offsets(rows, _ptr(out))
    model = np.array([[_tma_swizzle_128b(r, b) for b in range(128)] for r in range(rows)])
    np.testing.assert_array_equal(out, model)
    assert sorted(out.ravel().tolist()) == list(range(rows * 128))
    # an 8-byte group (4 bf16 of one noise float4) stays contiguous
    assert np.all(out[:, 1::2] - out[:, 0::2] == 1)


@pytest.mark.parametrize("addr", [0, 1024, 8192 + 32 * 3, 0x2C000 + 64])
def test_descriptor_fields(lib, addr):
    d = lib.descriptor(addr)
    assert d & 0x3FFF == (addr & 0x3FFFF) >> 4      # start address >> 4
    assert (d >> 16) & 0x3FFF == 1                   # leading byte offset (unused)
    assert (d >> 32) & 0x3FFF == 1024 >> 4           # 8 rows of 128 B
    assert (d >> 49) & 0x7 == 0                      # base offset
    assert d >> 62 == 1                              # 128-byte swizzle
    assert (d >> 14) & 0x3 == 0 and (d >> 30) & 0x3 == 0 and (d >> 46) & 0x7 == 0
    assert (d >> 52) & 0x3FF == 0


@pytest.mark.parametrize("n", [64, 256])
def test_accumulator_layout_covers_the_tile_once(lib, n):
    rows = np.zeros((128, n // 2), np.int32)
    cols = np.zeros((128, n // 2), np.int32)
    lib.acc_layout(n, _ptr(rows), _ptr(cols))
    # PTX's m64nNk16 f32 accumulator fragment: warp w, lane l, register i
    t = np.arange(128)[:, None]
    i = np.arange(n // 2)[None, :]
    np.testing.assert_array_equal(rows, 16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2))
    np.testing.assert_array_equal(cols, 8 * (i // 4) + 2 * (t % 4) + i % 2)
    flat = rows.astype(np.int64) * n + cols
    assert sorted(flat.ravel().tolist()) == list(range(64 * n))


@pytest.mark.parametrize("n", [64, 256])
def test_epilogue_exchanges_deliver_the_stored_elements(lib, n):
    tile = np.random.default_rng(n).normal(size=(64, n)).astype(np.float32)
    groups = n // 8
    held = np.zeros((128, groups, 4), np.float32)
    words = np.zeros((128, groups // 2, 4), np.uint32)
    lib.exchanges(_ptr(tile), n, _ptr(held), _ptr(words))
    prow = np.zeros(128, np.int32)
    pcol = np.zeros((128, groups), np.int32)
    lib.paired(n, _ptr(prow), _ptr(pcol))
    np.testing.assert_array_equal(prow, np.arange(128) // 32 * 16 + np.arange(128) % 32 // 4
                                  + 8 * (np.arange(128) % 2))
    # exchange 1: each thread holds the 4 consecutive columns it stores
    seen = np.zeros((64, n), np.int32)
    for t in range(128):
        for j in range(groups):
            c = pcol[t, j]
            assert c == 8 * j + 4 * ((t >> 1) & 1)
            np.testing.assert_array_equal(held[t, j], tile[prow[t], c:c + 4])
            seen[prow[t], c:c + 4] += 1
    assert np.all(seen == 1)
    # exchange 2: each thread holds the 8 columns of group 2 jj + hi, in order
    seen[:] = 0
    for t in range(128):
        hi = (t >> 1) & 1
        for jj in range(groups // 2):
            c = 8 * (2 * jj + hi)
            want = prow[t] * 4096 + c + 2 * np.arange(4)
            np.testing.assert_array_equal(words[t, jj], want)
            seen[prow[t], c:c + 8] += 1
    assert np.all(seen == 1)
