// CUDA kernel B3: the FK-GAN generator's dense trunk for inference, with a
// plain C interface for ctypes (dhaug_torch/ops/cuda_lib.py builds it,
// dhaug_torch/models/trunk_cuda.py binds it; no PyTorch headers).
//
// B3 trunk_layer_kernel replaces dhaug_tpu/models/trunk_pallas.py::
//    _trunk_kernel (trunk_pallas.py:52-65, launched by trunk_forward_pallas
//    :68-97), which computes in one pass
//      h   = relu(bf16(noise) w0 + b0)
//      3x: y = relu(bf16(h) wa + ba);  h = relu(bf16(y) wb + bb + h)
//      out = bf16(h) wh + bh
//    with bf16 x bf16 products, fp32 accumulation, fp32 bias and residual.
//
// Bound on an H100 SXM: operations.  At the synthesis batch B = 8192 and
// D = 1000 the trunk is 2 B (128 D + 6 D^2 + 35 D) = 1.01e11 FLOP, 0.102 ms
// at 989 TFLOP/s dense bf16; its irreducible bytes (12.3 MB of bf16
// weights, 4.2 MB of noise, 1.1 MB of output) take 5.3 us at 3.35 TB/s.
//
// Design (first port: right and simple).  One GEMM with a fused epilogue,
// launched once per layer (8 launches a trunk, all from dhtrunk_forward):
//    C[m, n] = epilogue(sum_k bf16(A[m, k]) W[n, k] + bias[n])
//  - A is the fp32 activation (M, K); each element is rounded to bf16
//    (to nearest even, as astype(bfloat16) does) when it is staged into
//    shared memory.  W is the bf16 weight in nn.Linear's (N, K) layout, K
//    contiguous: the column-major B operand of the tensor cores as it is.
//  - 128 x 128 output tiles, K in steps of 32; 8 warps of 64 x 32, each on
//    nvcuda::wmma 16x16x16 bf16 fragments with fp32 accumulators.  The next
//    K step is loaded into registers while the current one is multiplied
//    (two shared buffers, one barrier a step); 40 KB of static shared
//    memory, under the 48 KB that needs no opt-in.
//  - The epilogue adds the bias, then ReLU, or the fp32 residual and ReLU,
//    and stores fp32.  Rows past M (the ragged batch) load as zeros and are
//    not stored; weight rows past N (the head's 35) load as zeros and are
//    not stored.  The wrapper pads every K and the hidden width to a
//    multiple of 64 with zero weights and zero biases, so padded activation
//    columns are exactly 0 through ReLU and the residual.
//  - Cost of the simple design: the fp32 activations make a round trip
//    through HBM between layers, ~0.57 GB at B = 8192 (33.5 MB per read or
//    write of a (B, 1024) activation), ~0.17 ms at 3.35 TB/s, above the
//    0.102 ms bound; and wmma's mma.sync path reaches well under the
//    wgmma peak.  Keeping activations on chip, wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;            // output rows a block
constexpr int BN = 128;            // output columns a block
constexpr int BK = 32;             // K step
constexpr int kThreads = 256;      // 8 warps: 2 down x 4 across
constexpr int WM = 64;             // rows a warp
constexpr int WN = 32;             // columns a warp
constexpr int FM = WM / 16;        // wmma fragments down a warp's tile
constexpr int FN = WN / 16;        // wmma fragments across
constexpr int SK = BK + 8;         // shared row stride in bf16 (80 bytes):
                                   // 32-byte aligned fragment rows every 16,
                                   // and conflict-free 16-byte row reads

enum Epilogue : int { kNone = 0, kRelu = 1, kResidualRelu = 2 };

struct TileBuffers {
  __nv_bfloat16 a[2][BM][SK];
  __nv_bfloat16 b[2][BN][SK];
};

// the epilogue's per-warp staging reuses the tile buffers after the K loop
union SharedStorage {
  TileBuffers tiles;
  float stage[kThreads / 32][16 * 16];
};

// R and C may be the same buffer (the residual layer updates h in place):
// each element is read and written by the one thread that owns it.
__global__ void __launch_bounds__(kThreads)
trunk_layer_kernel(const float* __restrict__ A, const __nv_bfloat16* __restrict__ W,
                   const float* __restrict__ bias, const float* R, float* C,
                   int M, int N, int K, int epilogue) {
  __shared__ __align__(128) SharedStorage smem;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // A step: 128 x 32 fp32 = 1024 float4 (4 a thread); W step: 128 x 32 bf16
  // = 512 x 16 bytes (2 a thread).
  float4 ra[4];
  uint4 rb[2];
  auto load_step = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 3;
      const int c = (idx & 7) * 4;
      const int m = m0 + r;
      ra[i] = m < M ? *reinterpret_cast<const float4*>(A + static_cast<size_t>(m) * K + k0 + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 2;
      const int c = (idx & 3) * 8;
      const int n = n0 + r;
      rb[i] = n < N ? *reinterpret_cast<const uint4*>(W + static_cast<size_t>(n) * K + k0 + c)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_step = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 3;
      const int c = (idx & 7) * 4;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(&smem.tiles.a[buf][r][c]);
      dst[0] = __float22bfloat162_rn(make_float2(ra[i].x, ra[i].y));
      dst[1] = __float22bfloat162_rn(make_float2(ra[i].z, ra[i].w));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 2;
      const int c = (idx & 3) * 8;
      *reinterpret_cast<uint4*>(&smem.tiles.b[buf][r][c]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int steps = K / BK;
  load_step(0);
  store_step(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) load_step((s + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], &smem.tiles.a[cur][warp_m * WM + i * 16][kk], SK);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], &smem.tiles.b[cur][warp_n * WN + j * 16][kk], SK);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    // the buffer written here was last read in step s - 1, before the
    // barrier that ended it
    if (s + 1 < steps) store_step(cur ^ 1);
    __syncthreads();
  }

  // epilogue: each warp stages one 16 x 16 accumulator at a time; a lane
  // finishes 8 consecutive columns of one row
  float* stage = smem.stage[warp];
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + warp_m * WM + i * 16 + r;
      const int nb = n0 + warp_n * WN + j * 16 + c0;
      if (m < M) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = nb + c;
          if (n < N) {
            const size_t o = static_cast<size_t>(m) * N + n;
            float v = stage[r * 16 + c0 + c] + bias[n];
            if (epilogue == kRelu) {
              v = fmaxf(v, 0.f);
            } else if (epilogue == kResidualRelu) {
              v = fmaxf(v + R[o], 0.f);
            }
            C[o] = v;
          }
        }
      }
      __syncwarp();
    }
  }
}

int launch_layer(const float* A, const void* W, const void* bias, const float* R, float* C,
                 int M, int N, int K, int epilogue, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  trunk_layer_kernel<<<grid, kThreads, 0, stream>>>(
      A, static_cast<const __nv_bfloat16*>(W), static_cast<const float*>(bias), R, C, M, N,
      K, epilogue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The whole trunk: 8 launches of trunk_layer_kernel on the given stream.
// params holds the 16 operand pointers in trunk_weights' order (w0, b0,
// then wa, ba, wb, bb for each of the 3 blocks, then wh, bh): weights bf16
// (N, K) row-major, biases fp32 (N,).  noise is fp32 (B, K0); h and y are
// fp32 (B, D) scratch; out is fp32 (B, O).  K0 and D must be multiples of
// 32 and every pointer 16-byte aligned (the wrapper checks both).  Returns
// cudaGetLastError() of the first launch that fails, else 0.
extern "C" int dhtrunk_forward(const void* const* params, const void* noise, void* h, void* y,
                               void* out, int B, int K0, int D, int O, void* stream) {
  if (B <= 0) return 0;
  if (K0 % BK != 0 || D % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hp = static_cast<float*>(h);
  float* yp = static_cast<float*>(y);
  int rc = launch_layer(static_cast<const float*>(noise), params[0], params[1], nullptr, hp, B,
                        D, K0, kRelu, s);
  for (int blk = 0; blk < 3 && rc == 0; ++blk) {
    const int p = 2 + 4 * blk;
    rc = launch_layer(hp, params[p], params[p + 1], nullptr, yp, B, D, D, kRelu, s);
    if (rc == 0) {
      rc = launch_layer(yp, params[p + 2], params[p + 3], hp, hp, B, D, D, kResidualRelu, s);
    }
  }
  if (rc == 0) {
    rc = launch_layer(hp, params[14], params[15], nullptr, static_cast<float*>(out), B, O, D,
                      kNone, s);
  }
  return rc;
}

extern "C" const char* dhtrunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
