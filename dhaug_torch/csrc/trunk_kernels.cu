// CUDA kernel B3: the FK-GAN generator's dense trunk for inference, with a
// plain C interface for ctypes (dhaug_torch/ops/cuda_lib.py builds it,
// dhaug_torch/models/trunk_cuda.py binds it; no PyTorch headers).
//
// B3 trunk_gemm_kernel replaces dhaug_tpu/models/trunk_pallas.py::
//    _trunk_kernel (trunk_pallas.py:52-65, launched by trunk_forward_pallas
//    :68-97), which computes in one pass
//      h   = relu(bf16(noise) w0 + b0)
//      3x: y = relu(bf16(h) wa + ba);  h = relu((bf16(y) wb + bb) + h)
//      out = bf16(h) wh + bh
//    with bf16 x bf16 products, fp32 accumulation, fp32 bias and residual.
//
// Bound on an H100 SXM: operations.  At the synthesis batch B = 8192 and
// D = 1000 the trunk is 2 B (128 D + 6 D^2 + 35 D) = 1.01e11 FLOP, 0.102 ms
// at 989 TFLOP/s dense bf16; its irreducible bytes (12.3 MB of bf16
// weights, 4.2 MB of noise, 1.1 MB of output) take 5.3 us at 3.35 TB/s.
//
// Design: one GEMM with a fused epilogue, launched once per layer (8
// launches a trunk, all from dhtrunk_forward):
//    C[m, n] = epilogue(sum_k A[m, k] W[n, k] + bias[n])
// with A a bf16 activation (M, K) and W the bf16 weight in nn.Linear's
// (N, K) layout: both K-major operands of wgmma as they lie in memory.
//  - Tensor cores: wgmma.mma_async m64n256k16, bf16 x bf16 -> fp32, both
//    operands read from shared memory through 128-byte-swizzle
//    descriptors (trunk_sm90.cuh).  A block computes a 128 x 256 tile with
//    two consumer warpgroups of 64 x 256 (128 fp32 accumulators a thread).
//    At M = 8192, N = 1024 that is 64 x 4 = 256 tiles, 1.94 waves over the
//    132 SMs (one 194 KiB block an SM); the last wave's 124 tiles leave 8
//    SMs idle.  The head, 35 columns, takes 128 x 48 tiles (m64n48k16)
//    instead of computing 256.  A 64-wide k-block is 4 wgmmas a
//    warpgroup; each k-block's group is committed and the one before it
//    waited for (wait_group 1), so the tensor cores always have the next
//    group queued.
//  - Operand loads: one thread of a producer warpgroup issues TMA loads
//    (cp.async.bulk.tensor, __grid_constant__ CUtensorMap descriptors
//    encoded on the host by each call) of the A (128 x 64) and W (256 x 64)
//    tiles into a ring of 4 stages with a full and an empty mbarrier each;
//    no load passes through registers and no block-wide barrier runs in
//    the K loop.  The producer warpgroup gives up registers (setmaxnreg
//    40), the consumers take them (232): the layer b epilogue spills at the
//    168 a thread that a block of 384 (or of 288) threads starts with.
//    TMA zero-fills rows past M and N (the ragged batch, the head's 35
//    rows, D = 64 under a 256-wide tile).  The prelude's A is the fp32
//    noise (K = 128): each consumer warpgroup loads its 64 rows, rounds
//    them to bf16 and writes them into the two A stages in the same
//    swizzled layout TMA would write, so the trunk needs no extra launch.
//  - bf16 activations between layers: every activation whose next consumer
//    rounds it to bf16 is stored as bf16, rounded to nearest even in the
//    epilogue exactly as the next layer would round it (so the result is
//    the same function, not an approximation).  Layer a of each block
//    stores y as bf16 only; the prelude and layer b store h in fp32 (the
//    next block's residual) and its bf16 shadow (the next GEMM's A); the
//    last block skips the fp32 h, which nothing reads.  Traffic at
//    B = 8192: ~0.45 GB a trunk, down from ~0.57 GB with fp32 activations.
//  - Epilogue: the block's biases are read once into shared memory.  A
//    first pass adds the fp32 bias and then the fp32 residual in wgmma's
//    accumulator layout, with only loads, so a batch of residual loads is
//    in flight at once (h is read and written in place, so a load cannot
//    move above a store).  A second pass applies ReLU; two shuffles give
//    each lane 4 consecutive columns of one row, a 16-byte fp32 store, and
//    two more give it one 8-column group, a 16-byte bf16 store.  The
//    head's (B, 35) fp32 rows are 140 bytes apart, not a multiple of 16,
//    so it stores masked scalars from the accumulator layout.
//  - Padding: the wrapper pads every K and the hidden width to a multiple
//    of 64 (one swizzled k-block) with zero weights and biases, so padded
//    activation columns are exactly 0 through ReLU and the residual.
#include <cuda.h>  // CUtensorMap and the encoder's types; the encoder itself comes
                   // from cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "trunk_sm90.cuh"

namespace {

constexpr int BM = 128;                      // tile rows: 2 consumer warpgroups x 64
constexpr int kHiddenBN = 256;               // hidden layers' tile columns: m64n256k16
constexpr int kHeadBN = 48;                  // the head's 35 columns: m64n48k16
constexpr int BK = 64;                       // k-block: one 128-byte swizzled row
constexpr int kStages = 4;                   // TMA ring depth
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileA = BM * BK * 2;          // 16 KB

// the ring (A and W tiles), the bias row, the barriers, and slack to align
// the ring to 1024 bytes: 194 KiB at BN = 256, 89 KiB at BN = 48
constexpr int smem_bytes(int bn) {
  return kStages * (kTileA + bn * BK * 2) + bn * 4 + 2 * kStages * 8 +
         static_cast<int>(dhtrunk::kAtomBytes);
}
constexpr int kTensorMapError = 0x10000;     // + the CUresult of a failed encode

enum Epilogue : int {
  kPrelude = 0,   // A = fp32 noise; relu; store fp32 h and its bf16 shadow
  kHidden = 1,    // relu; store bf16 y
  kResidual = 2,  // relu((acc + b) + h); store fp32 h (if asked) and the shadow
  kHead = 3,      // acc + b; store fp32 (B, N), masked
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (c0 = column, c1 = row) of `map` into shared `dst`,
// completing `bar`'s transaction bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma and its waits
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 fp32, wgmma's accumulator layout) += A (64 x 16) B (16 x 256),
// both K-major in shared memory
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// the head's d (64 x 48) += A (64 x 16) B (16 x 48)
__device__ __forceinline__ void wgmma_k16(float (&d)[24], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// two floats -> bf16x2, each rounded to nearest even; lo at the lower address
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The prelude's A: this warpgroup's 64 rows of the fp32 noise (K columns,
// K <= kStages * BK), rounded to bf16 and written into the A stages in the
// layout a TMA load with the 128-byte swizzle would give.
__device__ __forceinline__ void stage_noise(uint8_t* a_tiles, const float* __restrict__ noise,
                                            int m0, int wg, int t, int M, int K) {
  constexpr int kBatch = 8;   // float4 loads a thread keeps in flight
  const int per_row = K / 4;  // float4 a row
  const int total = 64 * per_row;
  for (int base = t; base < total; base += 128 * kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + 128 * u;
      const int m = m0 + 64 * wg + idx / per_row;
      x[u] = idx < total && m < M
                 ? __ldg(reinterpret_cast<const float4*>(noise + static_cast<size_t>(m) * K +
                                                         4 * (idx % per_row)))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + 128 * u;
      if (idx < total) {
        const int r = 64 * wg + idx / per_row;  // row in the block's tile
        const int c = 4 * (idx % per_row);
        *reinterpret_cast<uint2*>(a_tiles + (c / BK) * kTileA +
                                  dhtrunk::sw128_offset(r, (c % BK) * 2)) =
            make_uint2(pack_bf16x2(x[u].x, x[u].y), pack_bf16x2(x[u].z, x[u].w));
      }
    }
  }
}

// One layer: C = epilogue(A W^T + bias) for a 128 x BN tile per block.
// resid and out_f32 may be the same buffer (layer b updates h in place):
// each element is read and written by the one thread that owns it.
template <int BN, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
trunk_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ noise,
                  const float* __restrict__ bias, const float* resid, float* out_f32,
                  __nv_bfloat16* __restrict__ out_bf16,
                  int M, int N, int K) {
  static_assert(EPI == kHead || BN % 64 == 0, "the stores pair 8-column groups, 8 at a time");
  constexpr int kTileB = BN * BK * 2;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment of the shared address
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t align = dhtrunk::kAtomBytes;
  uint8_t* smem = smem_raw + (((raw + align - 1) & ~(align - 1)) - raw);
  uint8_t* tiles_a = smem;
  uint8_t* tiles_b = smem + kStages * kTileA;
  float* bias_s = reinterpret_cast<float*>(tiles_b + kStages * kTileB);
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias_s + BN);
  const uint32_t sa = smem_u32(tiles_a), sb = smem_u32(tiles_b);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * kStages;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kblocks = K / BK;
  for (int i = threadIdx.x; i < BN; i += kThreads) bias_s[i] = n0 + i < N ? bias[n0 + i] : 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: one thread keeps the ring full; the warpgroup
    // hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      const uint32_t bytes = (EPI == kPrelude ? 0 : kTileA) + kTileB;
      for (int kb = 0, s = 0, phase = 0; kb < kblocks; ++kb) {
        mbar_wait(empty0 + 8 * s, phase ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(full0 + 8 * s, bytes);
        if (EPI != kPrelude) tma_load_2d(sa + s * kTileA, &tm_a, kb * BK, m0, full0 + 8 * s);
        tma_load_2d(sb + s * kTileB, &tm_w, kb * BK, n0, full0 + 8 * s);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    if (EPI == kPrelude) {
      // kblocks <= kStages (the host checks): stage kb holds k-block kb
      stage_noise(tiles_a, noise, m0, wg, t, M, K);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");   // this warpgroup
    }

    // this warpgroup's 64 rows of the A tile start 64 x 128 B = 8 KB in
    const uint32_t a_off = wg * 64 * dhtrunk::kRowBytes;
    int prev = 0;
    for (int kb = 0, s = 0, phase = 0; kb < kblocks; ++kb) {
      mbar_wait(full0 + 8 * s, phase);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_k16(acc, dhtrunk::sw128_desc(sa + s * kTileA + a_off + 32 * kk),
                  dhtrunk::sw128_desc(sb + s * kTileB + 32 * kk));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-block's group has finished reading its stage
      fence_acc(acc);
      if (kb > 0) mbar_arrive(empty0 + 8 * prev);
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    const int lane = t & 31;
    const int row0 = m0 + 64 * wg;  // first row of this warpgroup's tile
    if constexpr (EPI == kHead) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = row0 + dhtrunk::acc_row(t, i);
        const int c = dhtrunk::acc_col(t, i);
        if (r < M && n0 + c < N)
          out_f32[static_cast<size_t>(r) * N + n0 + c] = acc[i] + bias_s[c];
      }
    } else {
      // Pass 1, in the accumulator layout: acc + bias, then + the fp32
      // residual.  It loads and never stores, so the compiler may keep a
      // whole batch of residual loads in flight (out_f32 and resid alias,
      // so no load could move above a store of pass 2).  A quad of lanes
      // reads 32 contiguous bytes of a row: whole sectors.
      const int r_lo = row0 + dhtrunk::acc_row(t, 0);  // this thread's rows: r_lo, r_lo + 8
#pragma unroll
      for (int j0 = 0; j0 < BN / 8; j0 += 8) {
        float2 h[8][2];
        if constexpr (EPI == kResidual) {
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int c = n0 + dhtrunk::acc_col(t, 4 * (j0 + u));
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = r_lo + 8 * e;
              const float* src = resid + static_cast<size_t>(r) * N + c;
              h[u][e] = r < M && c < N ? *reinterpret_cast<const float2*>(src)
                                       : make_float2(0.f, 0.f);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u;
          const float2 b = *reinterpret_cast<const float2*>(bias_s + dhtrunk::acc_col(t, 4 * j));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[4 * j + 2 * e] += b.x;
            acc[4 * j + 2 * e + 1] += b.y;
            if constexpr (EPI == kResidual) {
              acc[4 * j + 2 * e] += h[u][e].x;
              acc[4 * j + 2 * e + 1] += h[u][e].y;
            }
          }
        }
      }

      // Pass 2: ReLU, the lane exchanges and the 16-byte stores.
      const int row = row0 + dhtrunk::paired_row(t);
      const bool row_ok = row < M;
      const bool odd = lane & 1, hi = lane & 2;
#pragma unroll
      for (int jj = 0; jj < BN / 16; ++jj) {
        uint32_t packed[4];  // bf16 of column groups 2 jj and 2 jj + 1
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * jj + half;
          const float x[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
          float s[2], r[2], v[4];
          dhtrunk::halves_send(x, odd, s);
          r[0] = __shfl_xor_sync(0xffffffffu, s[0], 1);
          r[1] = __shfl_xor_sync(0xffffffffu, s[1], 1);
          dhtrunk::halves_take(x, r, odd, v);
          const int c = dhtrunk::paired_col(t, j);
          const size_t o = static_cast<size_t>(row) * N + n0 + c;
          const bool ok = row_ok && n0 + c < N;
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = fmaxf(v[e], 0.f);
          if (EPI != kHidden && out_f32 != nullptr && ok)
            *reinterpret_cast<float4*>(out_f32 + o) = make_float4(v[0], v[1], v[2], v[3]);
          packed[2 * half] = pack_bf16x2(v[0], v[1]);
          packed[2 * half + 1] = pack_bf16x2(v[2], v[3]);
        }
        uint32_t s[2], r[2], g[4];
        dhtrunk::halves_send(packed, hi, s);
        r[0] = __shfl_xor_sync(0xffffffffu, s[0], 2);
        r[1] = __shfl_xor_sync(0xffffffffu, s[1], 2);
        dhtrunk::halves_take(packed, r, hi, g);
        const int c = 8 * (2 * jj + (hi ? 1 : 0));
        if (row_ok && n0 + c < N)
          *reinterpret_cast<uint4*>(out_bf16 + static_cast<size_t>(row) * N + n0 + c) =
              make_uint4(g[0], g[1], g[2], g[3]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, looked
// up once
int tensor_map_encoder(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  static const int rc = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && (q != cudaDriverEntryPointSuccess || p == nullptr))
      e = cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
    return static_cast<int>(e);
  }();
  *fn = found;
  return rc;
}

// descriptor of a row-major bf16 (rows, cols) matrix, loaded in boxes of
// box_rows x 64 with the 128-byte swizzle; out-of-bounds elements read as 0
int encode_bf16(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

template <int BN, int EPI>
int launch_layer(const CUtensorMap& a, const CUtensorMap& w, const float* noise, const void* bias,
                 const float* resid, float* out_f32, __nv_bfloat16* out_bf16, int M, int N, int K,
                 cudaStream_t stream) {
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      trunk_gemm_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BN));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  trunk_gemm_kernel<BN, EPI><<<grid, kThreads, smem_bytes(BN), stream>>>(
      a, w, noise, static_cast<const float*>(bias), resid, out_f32, out_bf16, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole trunk: 8 launches of trunk_gemm_kernel on the given stream.
// params holds the 16 operand pointers in trunk_weights' order (w0, b0,
// then wa, ba, wb, bb for each of the 3 blocks, then wh, bh): weights bf16
// (N, K) row-major, biases fp32 (N,).  noise is fp32 (B, K0); h is fp32
// (B, D) scratch, hs (h's bf16 shadow) and y bf16 (B, D) scratch; out is
// fp32 (B, O).  K0 and D must be multiples of 64, K0 at most 256, O at most
// 48, and every pointer 16-byte aligned (the wrapper checks all four).  Returns the
// first error: a cudaError_t, or kTensorMapError + the CUresult of a
// descriptor that did not encode; else 0.
extern "C" int dhtrunk_forward(const void* const* params, const void* noise, void* h, void* hs,
                               void* y, void* out, int B, int K0, int D, int O, void* stream) {
  if (B <= 0) return 0;
  if (K0 % BK != 0 || K0 > kStages * BK || D % BK != 0 || O > kHeadBN ||
      (B + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = nullptr;
  int rc = tensor_map_encoder(&fn);
  if (rc != 0) return rc;
  // tensor maps: the two bf16 activations (A) and the 8 weights (W)
  CUtensorMap t_hs, t_y, t_w[8];
  const CUtensorMap t_none = {};  // the prelude stages its A itself
  rc = encode_bf16(fn, &t_hs, hs, B, D, BM);
  if (rc == 0) rc = encode_bf16(fn, &t_y, y, B, D, BM);
  for (int i = 0; i < 8 && rc == 0; ++i) {
    const int n = i == 7 ? O : D, k = i == 0 ? K0 : D;
    rc = encode_bf16(fn, &t_w[i], params[2 * i], n, k, i == 7 ? kHeadBN : kHiddenBN);
  }
  if (rc != 0) return rc;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hp = static_cast<float*>(h);
  __nv_bfloat16* hsp = static_cast<__nv_bfloat16*>(hs);
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y);
  rc = launch_layer<kHiddenBN, kPrelude>(t_none, t_w[0], static_cast<const float*>(noise),
                                         params[1], nullptr, hp, hsp, B, D, K0, s);
  for (int blk = 0; blk < 3 && rc == 0; ++blk) {
    const int p = 1 + 2 * blk;
    rc = launch_layer<kHiddenBN, kHidden>(t_hs, t_w[p], nullptr, params[2 * p + 1], nullptr,
                                          nullptr, yp, B, D, D, s);
    if (rc == 0) {
      // the last block's fp32 h has no reader: the head reads the shadow
      rc = launch_layer<kHiddenBN, kResidual>(t_y, t_w[p + 1], nullptr, params[2 * p + 3], hp,
                                              blk < 2 ? hp : nullptr, hsp, B, D, D, s);
    }
  }
  if (rc == 0) {
    rc = launch_layer<kHeadBN, kHead>(t_hs, t_w[7], nullptr, params[15], nullptr,
                                      static_cast<float*>(out), nullptr, B, O, D, s);
  }
  return rc;
}

extern "C" const char* dhtrunk_error_string(int code) {
  static thread_local char text[96];
  if (code >= kTensorMapError) {
    snprintf(text, sizeof(text), "cuTensorMapEncodeTiled failed with CUresult %d",
             code - kTensorMapError);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
