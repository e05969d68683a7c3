// CUDA kernels of the DH forward kinematics (B1) and its VJP (B2), with a
// plain C interface for ctypes (dhaug_torch/ops/fk_cuda.py builds and binds
// them; no PyTorch headers).
//
// B1 fk_forward_kernel replaces dhaug_tpu/ops/fk_pallas.py::_fk_kernel
//    (fk_pallas.py:105-161, launched by fk_world_pose_pallas).
// B2 fk_backward_kernel replaces fk_pallas.py::_fk_bwd_kernel
//    (fk_pallas.py:355-502, launched by fk_bwd_pallas and paired with B1
//    by the custom_vjp at :547-576).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): both are memory-bound
// by their I/O.  B1 reads 54 floats a pose and writes 48 (408 B); at the
// main path's B = 1024 that is 418 KB, about 0.125 us, against ~2.5 kFLOP a
// pose (~0.04 us of fp32).  B2 reads 99 floats and writes 54 (612 B a pose,
// 627 KB, about 0.19 us).  Neither bound sets their time: on an H100 SXM
// (700 W) B1 takes ~22 us and B2 45-89 us a call at B = 1024 (PERF.md), the
// latency of one thread walking a pose's dependent chain while only 1024
// threads occupy the card.  Splitting a pose's chains across threads is the
// next step if the FK share of a GAN iteration (0.1% today) ever matters.
//
// Design: one thread per pose, so each thread computes what the Pallas
// kernel computes per lane; the per-pose math lives in fk_chain.cuh
// (__host__ __device__, also built for the CPU by the tests).  The ragged
// batch edge is masked, not padded.  Loads are strided at the natural
// (B, 33) / (B, 15) row-major layout: no transpose pass, since the time is
// the per-thread chain latency, not the loads, and a transpose would add a
// launch.  The backward keeps register pressure down by
// walking chain by chain and recomputing each link's Q from its angle, so
// only one chain's cumulative rotations (at most 13 x 9 floats) are live.
// Full-precision sinf/cosf (no fast-math).
#include <cuda_runtime.h>

#include "fk_chain.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
fk_forward_kernel(const float* __restrict__ ang, const float* __restrict__ bl,
                  const float* __restrict__ grot, const float* __restrict__ root,
                  float* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t i = static_cast<size_t>(b);
  dhfk::fk_pose_forward(ang + 33 * i, bl + 15 * i, grot + 3 * i, root + 3 * i,
                        out + 48 * i);
}

__global__ void __launch_bounds__(kThreads)
fk_backward_kernel(const float* __restrict__ ang, const float* __restrict__ bl,
                   const float* __restrict__ grot, const float* __restrict__ g,
                   float* __restrict__ dang, float* __restrict__ dbl,
                   float* __restrict__ dgrot, float* __restrict__ droot, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t i = static_cast<size_t>(b);
  dhfk::fk_pose_backward(ang + 33 * i, bl + 15 * i, grot + 3 * i, g + 48 * i,
                         dang + 33 * i, dbl + 15 * i, dgrot + 3 * i, droot + 3 * i);
}

}  // namespace

// Each launcher enqueues on the given stream and returns cudaGetLastError()
// (0 on success).  Pointers are contiguous float32 device buffers of the
// shapes named in fk_chain.cuh; the caller allocates the outputs.
extern "C" int dhfk_forward(const void* ang, const void* bl, const void* grot,
                            const void* root, void* out, int B, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  fk_forward_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ang), static_cast<const float*>(bl),
      static_cast<const float*>(grot), static_cast<const float*>(root),
      static_cast<float*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dhfk_backward(const void* ang, const void* bl, const void* grot,
                             const void* g, void* dang, void* dbl, void* dgrot,
                             void* droot, int B, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  fk_backward_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ang), static_cast<const float*>(bl),
      static_cast<const float*>(grot), static_cast<const float*>(g),
      static_cast<float*>(dang), static_cast<float*>(dbl), static_cast<float*>(dgrot),
      static_cast<float*>(droot), B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dhfk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
