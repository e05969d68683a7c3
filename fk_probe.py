#!/usr/bin/env python3
"""Where the FK kernels' time goes, phase by phase, on one NVIDIA card.

    python3 fk_probe.py

Builds two instrumented copies of the kernels in
``dhaug_torch/csrc/fk_kernels.cu`` -- the same phase functions of
``csrc/fk_chain.cuh`` in the same order, with thread 0 of each block reading
``clock64()`` after each phase's ``__syncthreads`` -- and a micro kernel that
times the fixed costs such phases are made of (a barrier, one ``cp.async``
and its wait, store rounds, sin/cos rounds).  Prints, at B = 1024 and 8192,
the median over blocks of each phase's SM cycles (12th launch) beside the
launch's device µs from torch.profiler, then the micro kernel's cycles.
Writes its build into ``dhaug_torch/_build/probe/``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent

_PROBE = r"""
#include <cuda_runtime.h>
#include "fk_chain.cuh"
using dhfk::kThreads; using dhfk::kTile;
#define MARK(k) if (tid == 0) probe[8 * blockIdx.x + (k)] = clock64();
__device__ inline int tile_poses(int B) {
  const int left = B - (int)blockIdx.x * kTile; return left < kTile ? left : kTile; }
template <class Tile> __device__ inline void trig_items(Tile& t, int n, int tid) {
  for (int it = tid; it < dhfk::kTrig * kTile; it += kThreads)
    if (it % kTile < n) dhfk::trig_item(t, it); }
__global__ void __launch_bounds__(kThreads, 2)
fwd(const float* __restrict__ ang, const float* __restrict__ bl, const float* __restrict__ grot,
    const float* __restrict__ root, float* __restrict__ out, int B, long long* probe) {
  __shared__ dhfk::FwdTile t;
  const size_t base = (size_t)blockIdx.x * kTile;
  const int n = tile_poses(B), tid = threadIdx.x, job = tid / 32, pose = tid % 32;
  MARK(0)
  dhfk::load_fwd(t, ang, bl, grot, root, base, n, tid, kThreads); __syncthreads(); MARK(1)
  trig_items(t, n, tid); __syncthreads(); MARK(2)
  if (job < dhfk::kChains && pose < n) dhfk::fwd_chain_item(t, job, pose); __syncthreads(); MARK(3)
  dhfk::store_fwd(t, out, base, n, tid, kThreads); __syncthreads(); MARK(4)
}
__global__ void __launch_bounds__(kThreads, 2)
bwd(const float* __restrict__ ang, const float* __restrict__ bl, const float* __restrict__ grot,
    const float* __restrict__ g, float* __restrict__ dang, float* __restrict__ dbl,
    float* __restrict__ dgrot, float* __restrict__ droot, int B, long long* probe) {
  extern __shared__ __align__(16) unsigned char smem[];
  dhfk::BwdTile& t = *reinterpret_cast<dhfk::BwdTile*>(smem);
  const size_t base = (size_t)blockIdx.x * kTile;
  const int n = tile_poses(B), tid = threadIdx.x, job = tid / 32, pose = tid % 32;
  MARK(0)
  dhfk::load_bwd(t, ang, bl, grot, g, base, n, tid, kThreads); __syncthreads(); MARK(1)
  trig_items(t, n, tid); __syncthreads(); MARK(2)
  if (job < dhfk::kChains && pose < n) dhfk::bwd_chain_item(t, job, pose); __syncthreads(); MARK(3)
  if (job <= dhfk::kChains && pose < n) dhfk::bwd_reverse_item(t, job, pose); __syncthreads(); MARK(4)
  dhfk::store_bwd(t, dang, dbl, dgrot, droot, base, n, tid, kThreads); __syncthreads(); MARK(5)
}
// fixed costs: barrier | cp.async 16 B + wait | 1 and 3 rounds of shared->global
// stores | 1 and 2.25 rounds of sin/cos (the kernels' precise_sincos)
__global__ void __launch_bounds__(512, 2) micro(const float* __restrict__ in, float* __restrict__ out,
                                                long long* probe) {
  __shared__ __align__(16) float s[4096];
  const int tid = threadIdx.x; const size_t base = (size_t)blockIdx.x * 2048;
  MARK(0)
  __syncthreads(); MARK(1)
  dhfk::copy16(s + 4 * tid, in + base + 4 * tid); dhfk::copy_wait(); __syncthreads(); MARK(2)
  out[base + tid] = s[tid]; __syncthreads(); MARK(3)
  for (int i = tid; i < 1536; i += 512) out[base + i] = s[i + 7]; __syncthreads(); MARK(4)
  { float a, b; dhfk::precise_sincos(s[tid], a, b); s[tid + 2048] = a + b; } __syncthreads(); MARK(5)
  for (int i = tid; i < 1152; i += 512) { float a, b; dhfk::precise_sincos(s[i], a, b); s[i + 2048] = a + b; }
  __syncthreads(); MARK(6)
}
extern "C" int probe_fwd(const void* a, const void* b, const void* c, const void* d, void* o, int B,
                         void* p) {
  fwd<<<(B + kTile - 1) / kTile, kThreads>>>((const float*)a, (const float*)b, (const float*)c,
                                            (const float*)d, (float*)o, B, (long long*)p);
  return cudaGetLastError(); }
extern "C" int probe_bwd(const void* a, const void* b, const void* c, const void* g, void* o1,
                         void* o2, void* o3, void* o4, int B, void* p) {
  cudaFuncSetAttribute(bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(dhfk::BwdTile));
  bwd<<<(B + kTile - 1) / kTile, kThreads, sizeof(dhfk::BwdTile)>>>(
      (const float*)a, (const float*)b, (const float*)c, (const float*)g, (float*)o1, (float*)o2,
      (float*)o3, (float*)o4, B, (long long*)p);
  return cudaGetLastError(); }
extern "C" int probe_micro(const void* in, void* out, void* p, int blocks) {
  micro<<<blocks, 512>>>((const float*)in, (float*)out, (long long*)p); return cudaGetLastError(); }
"""

FWD_PHASES = ("load", "trig", "chains", "store")
BWD_PHASES = ("load", "trig", "chains", "reverse", "store")
MICRO_PHASES = ("barrier", "cp.async 16 B + wait", "store 1 round", "store 3 rounds",
                "sincos 1 round", "sincos 2.25 rounds")


def phase_cycles(probe, blocks: int, n_phases: int) -> list:
    t = probe.view(-1, 8)[:blocks].cpu().double()
    return [statistics.median((t[:, i + 1] - t[:, i]).tolist()) for i in range(n_phases)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fk_probe.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from dhaug_torch.ops import cuda_lib

    build = cuda_lib.BUILD_ROOT / "probe"
    build.mkdir(parents=True, exist_ok=True)
    (build / "fk_probe.cu").write_text(_PROBE)
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_lib._nvcc(), *flags, f"-I{cuda_lib.CSRC}", "-o",
                    str(build / "libfk_probe.so"), str(build / "fk_probe.cu")], check=True)
    lib = ctypes.CDLL(str(build / "libfk_probe.so"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.probe_fwd.argtypes = [vp] * 5 + [ci, vp]
    lib.probe_bwd.argtypes = [vp] * 8 + [ci, vp]
    lib.probe_micro.argtypes = [vp] * 3 + [ci]
    device = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)

    for B in chip_smoke.FK_TIMED_B:
        ang, bl, grot, root, cot = chip_smoke.fk_inputs(B, seed=7, device=device)
        blocks = (B + 31) // 32
        probe = torch.zeros(blocks * 8, dtype=torch.int64, device=device)
        out = torch.empty(B, 16, 3, device=device)
        grads = [torch.empty(B, n, device=device) for n in (33, 15, 3, 3)]
        runs = {
            "fwd": (FWD_PHASES, lambda: lib.probe_fwd(ang.data_ptr(), bl.data_ptr(), grot.data_ptr(),
                                                      root.data_ptr(), out.data_ptr(), B,
                                                      probe.data_ptr())),
            "bwd": (BWD_PHASES, lambda: lib.probe_bwd(ang.data_ptr(), bl.data_ptr(), grot.data_ptr(),
                                                      cot.data_ptr(), *[g.data_ptr() for g in grads],
                                                      B, probe.data_ptr()))}
        for kind, (phases, launch) in runs.items():
            for _ in range(12):
                launch()
                torch.cuda.synchronize()
            cycles = phase_cycles(probe, blocks, len(phases))
            chip_smoke.emit({"fk_probe": kind, "B": B, "phase_cycles": dict(zip(phases, cycles)),
                             "sum_cycles": sum(cycles),
                             "device_us": chip_smoke.device_us(launch)})

    for blocks in (32, 256):
        data = torch.randn(blocks * 2048 + 4096, device=device)
        out = torch.empty_like(data)
        probe = torch.zeros(blocks * 8, dtype=torch.int64, device=device)
        for _ in range(6):
            lib.probe_micro(data.data_ptr(), out.data_ptr(), probe.data_ptr(), blocks)
            torch.cuda.synchronize()
        chip_smoke.emit({"fk_probe": "micro", "blocks": blocks, "threads": 512,
                         "cycles": dict(zip(MICRO_PHASES,
                                            phase_cycles(probe, blocks, len(MICRO_PHASES))))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
