// Index math of kernel B3 (trunk_kernels.cu) that needs no card: the
// 128-byte swizzle of a TMA tile, the wgmma shared-memory descriptor, the
// wgmma accumulator layout and the epilogue's lane exchanges.  Every
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

// The epilogue's two lane exchanges share one shape.  Lanes l and l ^ mask
// each hold x = [a0, a1, b0, b1], two pairs of one kind (two rows, or two
// column groups); the lane with (l & mask) set ("hi") ends with the
// partner's second pair then its own, the other lane with its own first pair
// then the partner's.  One lane sends `s` (__shfl_xor_sync(.., mask)) and
// gets the partner's `s` as `r`.
//
// Exchange 1 (mask 1, floats): register group j of a thread, acc[4j..4j+3],
// is row r, columns c, c + 1 and row r + 8, the same columns (c = 8j + 2q,
// q = lane % 4).  Afterwards the lane holds 4 consecutive columns of one
// row, paired_row / paired_col below: a 16-byte fp32 store.
// Exchange 2 (mask 2, packed bf16 pairs): after exchange 1, lanes q and
// q ^ 2 hold the two halves of the same row's column groups j and j + 1;
// afterwards the lane holds all 8 columns of group j + hi: a 16-byte bf16
// store.
template <class T>
__host__ __device__ inline void halves_send(const T x[4], bool hi, T s[2]) {
  s[0] = hi ? x[0] : x[2];
  s[1] = hi ? x[1] : x[3];
}
template <class T>
__host__ __device__ inline void halves_take(const T x[4], const T r[2], bool hi, T v[4]) {
  v[0] = hi ? r[0] : x[0];
  v[1] = hi ? r[1] : x[1];
  v[2] = hi ? x[2] : r[0];
  v[3] = hi ? x[3] : r[1];
}

// After exchange 1: the row (in the warpgroup's tile) that thread t holds,
// and the first of its 4 columns in column group j.
__host__ __device__ inline int paired_row(int t) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * (t & 1);
}
__host__ __device__ inline int paired_col(int t, int j) {
  return 8 * j + 4 * ((t >> 1) & 1);
}

}  // namespace dhtrunk
