// Index math of kernel B3 (trunk_kernels.cu) that needs no card: the 128-
// and 64-byte swizzles of TMA tiles, the wgmma shared-memory descriptor,
// the wgmma accumulator layout and the persistent tile schedule.  Every
// function is __host__ __device__ and free of CUDA headers, so
// tests/test_torch_trunk_host.py builds this header with
// g++ -D__host__= -D__device__= and holds it to a Python model.
#pragma once
#include <stdint.h>

namespace dhtrunk {

// One row of a swizzled operand tile: 64 bf16 = 128 bytes, the widest row
// CU_TENSOR_MAP_SWIZZLE_128B takes; the pattern repeats every 8 rows
// (1024 bytes), so every tile starts on a 1024-byte boundary.
constexpr uint32_t kRowBytes = 128;
constexpr uint32_t kAtomBytes = 1024;

// Byte offset, from the tile's start, of byte b (0..127) of row `row` as TMA
// writes a tile with CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk index
// (b / 16) is XORed with the row index mod 8.
__host__ __device__ inline uint32_t sw128_offset(uint32_t row, uint32_t b) {
  return row * kRowBytes + ((((b >> 4) ^ row) & 7u) << 4) + (b & 15u);
}

// The same for a tile of 64-byte rows written or read by TMA with
// CU_TENSOR_MAP_SWIZZLE_64B (the epilogue's bf16 store boxes of 32 columns):
// address bits 4-5 (the 16-byte chunk) are XORed with bits 7-8, so the
// pattern repeats every 8 rows (512 bytes).
__host__ __device__ inline uint32_t sw64_offset(uint32_t row, uint32_t b) {
  const uint32_t plain = row * 64 + b;
  return plain ^ (((plain >> 7) & 3u) << 4);
}

// wgmma shared-memory matrix descriptor of a K-major bf16 operand in that
// layout, starting at shared address `addr`:
//   bits  0-13  start address >> 4
//   bits 16-29  leading byte offset >> 4: unused by swizzled K-major
//               operands, set to 1 as CUTLASS does
//   bits 32-45  stride byte offset >> 4: 8 rows of 128 B = 1024 B -> 64
//   bits 49-51  base offset 0: tiles start on 1024-byte boundaries
//   bits 62-63  layout 1 = 128-byte swizzle
// A k16 step inside the 64-wide k-block adds 32 bytes to `addr`; the
// hardware applies the XOR to the address it forms, as TMA did.
__host__ __device__ inline uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Row and column, in the warpgroup's 64 x N tile, of accumulator register i
// of thread t (0..127) after wgmma.m64nNk16 with f32 accumulators: warp
// t / 32 owns rows 16 (t / 32) .. +15; register i covers column group i / 4
// (8 columns), row +8 when bit 1 of i is set, the odd column when bit 0 is.
__host__ __device__ inline int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__host__ __device__ inline int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// The persistent schedule.  A layer's output is cut into units of
// `unit_rows` x `bn` (a unit is one 64-row tile, or one per block of a
// cluster that splits it by rows), numbered with the column fastest:
// unit u covers row unit u / n_units, column tile u % n_units.  Worker w of
// `workers` (a block, or a cluster) takes units w, w + workers,
// w + 2 workers, ...: at any moment the workers hold consecutive units, so
// the column tiles of one row panel run together and share its A rows in
// L2.  A worker's two consumer warpgroups take its units in turn.
__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int unit_count(int rows, int cols, int unit_rows, int bn) {
  return ceil_div(rows, unit_rows) * ceil_div(cols, bn);
}

// units worker w takes of `units`
__host__ __device__ inline int worker_units(int w, int workers, int units) {
  return w < units ? (units - 1 - w) / workers + 1 : 0;
}

// row and column of the first element of worker w's j-th unit
__host__ __device__ inline void unit_origin(int w, int workers, int j, int cols, int unit_rows,
                                            int bn, int* m0, int* n0) {
  const int u = w + j * workers;
  const int n_units = ceil_div(cols, bn);
  *m0 = (u / n_units) * unit_rows;
  *n0 = (u % n_units) * bn;
}

}  // namespace dhtrunk
