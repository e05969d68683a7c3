"""Kernel B3's index math (dhaug_torch/csrc/trunk_sm90.cuh), built for the
host with g++, against a Python model: the 128- and 64-byte swizzles of
TMA tiles, the wgmma shared-memory descriptor, wgmma's accumulator layout,
where the epilogue stages each element for its TMA store and the
persistent tile schedule.

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
extern "C" void swizzle64_offsets(int rows, unsigned* out) {
  for (int r = 0; r < rows; ++r)
    for (int b = 0; b < 64; ++b) out[r * 64 + b] = sw64_offset(r, b);
}
// the epilogue's writes of one 32-column chunk into its staging buffers, as
// store_tile makes them: thread t's pairs of rows acc_row(t, 0) and + 8,
// columns 8 g + 2 (t % 4) and + 1; each element written as its code
// row * 32 + column, 4 bytes into the fp32 box, 2 into the bf16 box
extern "C" void staging(unsigned char* f32_box, unsigned char* bf16_box) {
  for (int t = 0; t < 128; ++t)
    for (int g = 0; g < 4; ++g)
      for (int e = 0; e < 2; ++e)
        for (int h = 0; h < 2; ++h) {
          const int r = acc_row(t, 0) + 8 * e, c = 8 * g + 2 * (t & 3) + h;
          const unsigned code = r * 32 + c;
          unsigned char* p32 = f32_box + sw128_offset(r, 4 * c);
          unsigned char* p16 = bf16_box + sw64_offset(r, 2 * c);
          for (int k = 0; k < 4; ++k) p32[k] = (code >> (8 * k)) & 0xff;
          for (int k = 0; k < 2; ++k) p16[k] = (code >> (8 * k)) & 0xff;
        }
}
extern "C" int units_of(int rows, int cols, int unit_rows, int bn) {
  return unit_count(rows, cols, unit_rows, bn);
}
// the persistent schedule as the kernel walks it: for each worker, each of
// its units in order, the row (w, j, m0, n0); returns the rows written
extern "C" int schedule(int rows, int cols, int unit_rows, int bn, int workers, int* out) {
  const int units = unit_count(rows, cols, unit_rows, bn);
  int k = 0;
  for (int w = 0; w < workers; ++w)
    for (int j = 0; j < worker_units(w, workers, units); ++j) {
      int m0, n0;
      unit_origin(w, workers, j, cols, unit_rows, bn, &m0, &n0);
      out[4 * k] = w;
      out[4 * k + 1] = j;
      out[4 * k + 2] = m0;
      out[4 * k + 3] = n0;
      ++k;
    }
  return k;
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
    lib.swizzle64_offsets.argtypes = [ci, vp]
    lib.staging.argtypes = [vp, vp]
    lib.units_of.argtypes = [ci, ci, ci, ci]
    lib.units_of.restype = ci
    lib.schedule.argtypes = [ci, ci, ci, ci, ci, vp]
    lib.schedule.restype = ci
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


def _tma_swizzle_64b(row: int, b: int) -> int:
    """Python model of CU_TENSOR_MAP_SWIZZLE_64B on 64-byte rows: the
    16-byte chunk b // 16 of row r lands at chunk (b // 16) ^ ((r // 2) % 4)
    of its row (the pattern repeats every 8 rows, 512 bytes)."""
    return row * 64 + ((b // 16) ^ ((row // 2) % 4)) * 16 + b % 16


@pytest.mark.parametrize("rows", [8, 64])
def test_swizzle64_matches_the_tma_pattern_and_is_a_permutation(lib, rows):
    out = np.zeros((rows, 64), np.uint32)
    lib.swizzle64_offsets(rows, _ptr(out))
    model = np.array([[_tma_swizzle_64b(r, b) for b in range(64)] for r in range(rows)])
    np.testing.assert_array_equal(out, model)
    assert sorted(out.ravel().tolist()) == list(range(rows * 64))
    # a bf16 pair (4 bytes) stays contiguous
    assert np.all(out[:, 1::2] - out[:, 0::2] == 1)


@pytest.mark.parametrize("box", ["fp32", "bf16"])
def test_epilogue_staging_fills_each_tma_box_once(lib, box):
    """The 128 threads' writes of one 32-column chunk, in the accumulator
    layout, land where a TMA store of the 64 x 32 box with the map's swizzle
    reads each element: every element once, in its place."""
    f32 = np.full(64 * 32 * 4, 0xFF, np.uint8)
    bf16 = np.full(64 * 32 * 2, 0xFF, np.uint8)
    lib.staging(_ptr(f32), _ptr(bf16))
    codes = np.arange(64 * 32).reshape(64, 32)
    if box == "fp32":  # 128-byte rows, CU_TENSOR_MAP_SWIZZLE_128B
        words = f32.view(np.uint32)
        got = np.array([[words[_tma_swizzle_128b(r, 4 * c) // 4] for c in range(32)]
                        for r in range(64)])
    else:  # 64-byte rows, CU_TENSOR_MAP_SWIZZLE_64B; codes cut to 16 bits
        halves = bf16.view(np.uint16)
        got = np.array([[halves[_tma_swizzle_64b(r, 2 * c) // 2] for c in range(32)]
                        for r in range(64)])
        codes = codes & 0xFFFF
    np.testing.assert_array_equal(got, codes)


# the synthesis width (D = 1000 padded to 1024) and D = 64 in 256-wide
# tiles, the head's 35 columns in one 48-wide tile; 64-row units (one
# block) and 128-row units (a cluster of two blocks)
SCHEDULE_SHAPES = [(1024, 256, 64), (1024, 256, 128), (64, 256, 128), (35, 48, 64)]


@pytest.mark.parametrize("cols,bn,unit_rows", SCHEDULE_SHAPES)
@pytest.mark.parametrize("rows", [1, 63, 64, 8192, 65536 + 37])
def test_persistent_schedule_visits_every_tile_once_column_fastest(lib, rows, cols, bn,
                                                                   unit_rows):
    n_cols = -(-cols // bn)
    units = -(-rows // unit_rows) * n_cols
    assert lib.units_of(rows, cols, unit_rows, bn) == units
    # every tile in the order of the unit numbers: row panel by row panel,
    # the column tile fastest
    row_major = [(m * unit_rows, n * bn) for m in range(units // n_cols) for n in range(n_cols)]
    for workers in sorted({1, max(units - 1, 1), units, units + 5, 132, 66}):
        out = np.full((units, 4), -1, np.int32)
        assert lib.schedule(rows, cols, unit_rows, bn, workers, _ptr(out)) == units
        w, j, m0, n0 = out.T
        # worker w's j-th unit is unit w + j * workers; a worker past the
        # unit count gets none, the others differ by at most one unit
        u = w + j * workers
        assert sorted(u.tolist()) == list(range(units))
        per_worker = np.bincount(w, minlength=workers)
        assert per_worker[:min(workers, units)].min() >= 1
        assert per_worker.max() - per_worker[:min(workers, units)].min() <= 1
        assert np.all(per_worker[units:] == 0)
        for k in range(1, units):  # a worker's units come in increasing order
            if w[k] == w[k - 1]:
                assert j[k] == j[k - 1] + 1 and u[k] > u[k - 1]
        order = np.argsort(u)
        assert list(zip(m0[order].tolist(), n0[order].tolist())) == row_major
        assert np.all(m0 < -(-rows // unit_rows) * unit_rows) and np.all(n0 < n_cols * bn)
