// CUDA kernels of the DH forward kinematics (B1) and its VJP (B2), with a
// plain C interface for ctypes (dhaug_torch/ops/cuda_lib.py builds them,
// dhaug_torch/ops/fk_cuda.py binds them; no PyTorch headers).
//
// B1 fk_forward_kernel replaces dhaug_tpu/ops/fk_pallas.py::_fk_kernel
//    (fk_pallas.py:105-161, launched by fk_world_pose_pallas).
// B2 fk_backward_kernel replaces fk_pallas.py::_fk_bwd_kernel
//    (fk_pallas.py:355-502, launched by fk_bwd_pallas and paired with B1
//    by the custom_vjp at :547-576).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): both are bound by
// their I/O.  B1 reads 54 floats a pose and writes 48 (408 B); at the main
// path's B = 1024 that is 418 KB, 0.125 us, against ~2.5 kFLOP a pose
// (0.04 us of fp32).  B2 reads 99 floats and writes 54 (612 B a pose, 0.19 us
// at B = 1024).  Both bounds lie below the cost of one launch (a few us), so
// what a call costs is its dependent latency: loads, the longest chain of
// 3x3 compositions, and the barriers between phases.
//
// Design: a block takes kTile = 32 consecutive poses, one a lane, with 512
// threads (32 blocks at B = 1024; at B = 8192 256 blocks, two an SM, all
// resident at once), in phases separated by __syncthreads (the per-item
// math is in fk_chain.cuh, which the CPU tests also build with g++ and run
// through the same phases):
//   load   the tile's rows of each (B, n) array are one contiguous span,
//          copied into shared memory with cp.async (16-byte pieces where
//          the span starts 16-byte aligned, 4-byte ones otherwise and for
//          the tail: the wrappers accept any 4-byte-aligned tensor), every
//          copy in flight before one wait;
//   trig   the 36 (cos, sin) pairs a pose (33 links, 3 Euler angles) over
//          the block's threads, of exactly the plain FK's argument, computed
//          in double and rounded (no slow path, so no stack frame: sinf's
//          Payne-Hanek array took 32 bytes of local memory under the
//          64-register cap);
//   chains a warp a job (0-4: a chain, lane = pose), each chain's links
//          unrolled from compile-time tables; the arms walk body links 0-8
//          themselves, so no chain waits for another: the critical path is
//          14 compositions, not the 30 of one thread walking a whole pose;
//   B1     each chain writes its joints' Rg p + root into a shared output
//          tile, which leaves as 16-byte stores;
//   B2     every link's cumulative (R, p) goes to shared memory; then each
//          chain's warp takes the revolute-joint Jacobian from its last
//          link back (dtheta = z . W, dt = R^T U: no 3x3 dR recurrence),
//          job 5's warp the global rotation and root gradients, and the
//          tile's gradients leave as contiguous spans.
// Arrays that a warp's lanes read at one offset a pose have odd per-pose
// strides, so the 32 lanes fall in 32 banks.  No fast-math.
//
// On an H100 SXM (700 W) a launch takes ~4.5 us of device time for B1 and
// ~7 us for B2 at B = 1024 (PERF.md): each of the 4-5 phases costs 1-2 k
// cycles whatever its item count, so the time is set by the phases' count
// and the launch, not by the batch or the bytes.
#include <cuda_runtime.h>

#include "fk_chain.cuh"

namespace {

using dhfk::kThreads;
using dhfk::kTile;

// Two blocks an SM (64 registers a thread at most): B = 8192's 256 blocks
// fit the card's 132 SMs at once.
constexpr int kBlocksPerSM = 2;

__device__ inline int tile_poses(int B) {
  const int left = B - static_cast<int>(blockIdx.x) * kTile;
  return left < kTile ? left : kTile;
}

template <class Tile>
__device__ inline void trig_items(Tile& t, int n, int tid) {
  for (int it = tid; it < dhfk::kTrig * kTile; it += kThreads)
    if (it % kTile < n) dhfk::trig_item(t, it);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fk_forward_kernel(const float* __restrict__ ang, const float* __restrict__ bl,
                  const float* __restrict__ grot, const float* __restrict__ root,
                  float* __restrict__ out, int B) {
  __shared__ dhfk::FwdTile t;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  const int n = tile_poses(B), tid = threadIdx.x, job = tid / 32, pose = tid % 32;
  dhfk::load_fwd(t, ang, bl, grot, root, base, n, tid, kThreads);
  __syncthreads();
  trig_items(t, n, tid);
  __syncthreads();
  if (job < dhfk::kChains && pose < n) dhfk::fwd_chain_item(t, job, pose);
  __syncthreads();
  dhfk::store_fwd(t, out, base, n, tid, kThreads);
}

// BwdTile (81 KB) is dynamic shared memory.
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fk_backward_kernel(const float* __restrict__ ang, const float* __restrict__ bl,
                   const float* __restrict__ grot, const float* __restrict__ g,
                   float* __restrict__ dang, float* __restrict__ dbl,
                   float* __restrict__ dgrot, float* __restrict__ droot, int B) {
  extern __shared__ __align__(16) unsigned char smem[];
  dhfk::BwdTile& t = *reinterpret_cast<dhfk::BwdTile*>(smem);
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  const int n = tile_poses(B), tid = threadIdx.x, job = tid / 32, pose = tid % 32;
  dhfk::load_bwd(t, ang, bl, grot, g, base, n, tid, kThreads);
  __syncthreads();
  trig_items(t, n, tid);
  __syncthreads();
  if (job < dhfk::kChains && pose < n) dhfk::bwd_chain_item(t, job, pose);
  __syncthreads();
  if (job <= dhfk::kChains && pose < n) dhfk::bwd_reverse_item(t, job, pose);
  __syncthreads();
  dhfk::store_bwd(t, dang, dbl, dgrot, droot, base, n, tid, kThreads);
}

int blocks_for(int B) { return (B + kTile - 1) / kTile; }

}  // namespace

// Each launcher enqueues on the given stream and returns cudaGetLastError()
// (0 on success).  Pointers are contiguous float32 device buffers of the
// shapes named in fk_chain.cuh, 4-byte aligned; the caller allocates the
// outputs.
extern "C" int dhfk_forward(const void* ang, const void* bl, const void* grot,
                            const void* root, void* out, int B, void* stream) {
  if (B <= 0) return 0;
  fk_forward_kernel<<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ang), static_cast<const float*>(bl),
      static_cast<const float*>(grot), static_cast<const float*>(root),
      static_cast<float*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dhfk_backward(const void* ang, const void* bl, const void* grot,
                             const void* g, void* dang, void* dbl, void* dgrot,
                             void* droot, int B, void* stream) {
  if (B <= 0) return 0;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fk_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(dhfk::BwdTile));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  fk_backward_kernel<<<blocks_for(B), kThreads, sizeof(dhfk::BwdTile),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ang), static_cast<const float*>(bl),
      static_cast<const float*>(grot), static_cast<const float*>(g),
      static_cast<float*>(dang), static_cast<float*>(dbl), static_cast<float*>(dgrot),
      static_cast<float*>(droot), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dhfk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
