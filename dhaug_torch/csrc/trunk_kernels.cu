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
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s), per
// layer at B = 65536 rows and D = 1000 (padded to 1024), with the storage
// types below:
//    prelude   K = 128 GEMM, 17 GFLOP (0.017 ms); reads the fp32 noise and
//              writes fp32 h and its bf16 shadow, 0.44 GB (0.13 ms): bytes
//    layer a   137 GFLOP (0.139 ms); reads the bf16 shadow and writes bf16
//              y, 0.27 GB (0.08 ms): operations
//    layer b   137 GFLOP (0.139 ms); reads bf16 y and the fp32 residual and
//              writes fp32 h and the shadow, 0.80 GB (0.24 ms): bytes
//    head      4.7 GFLOP; reads the shadow, 0.14 GB (0.04 ms): bytes
// The trunk needs 0.82 ms of operations and 1.05 ms of bytes a layer at a
// time; the algorithmic bound (each trunk input read once, its output
// written once) is the operations' 0.817 ms.  A layer comes near the larger
// of its two only if its epilogue's traffic runs while the tensor cores
// work.  On the card (one H100 at 700 W) the kernel below takes 1.90-1.95
// ms a trunk at B = 65536 (prelude 0.20, layer a 0.21, layer b 0.35, the
// last layer b 0.29, head 0.05 ms) and 0.28 ms at 8192; the non-persistent
// kernel of 128-row tiles it replaced took 2.09-2.19 and 0.30.  What paces
// it now is L2: each D x D layer moves ~2-3 GB through it (operand tiles,
// the epilogue's traffic, device memory's fills and write-backs), and
// prefetching layer b's residual into L2 made layer b 15% slower.
//
// Design: one GEMM with a fused epilogue, launched once per layer (8
// launches a trunk, all from dhtrunk_forward):
//    C[m, n] = epilogue(sum_k A[m, k] W[n, k] + bias[n])
// with A a bf16 activation (M, K) and W the bf16 weight in nn.Linear's
// (N, K) layout: both K-major operands of wgmma as they lie in memory.
//  - Persistent blocks: a launch takes at most one block an SM
//    (min(tiles, SMs); in clusters, as many pairs as fit at once), and each
//    block walks a static schedule of output tiles, column tile fastest
//    (trunk_sm90.cuh: unit_origin), so the column tiles of one row panel
//    run at once on neighbouring blocks and read their A rows from L2.
//    With fewer tiles than SMs each block takes one tile.
//  - Warp specialization: a block has a producer warpgroup and two
//    consumer warpgroups.  Two schedules share the code:
//     - ping-pong (the prelude, layer b, the head, and layer a at small
//       batches): each consumer warpgroup owns a 64-row tile in turn
//       (tiles j, j + 2, ... of the block's list), and the tensor cores go
//       to one warpgroup at a time: a warpgroup waits at a named barrier
//       until the other has issued the wgmmas of the tile before its own,
//       issues its whole mainloop and hands the turn on before it waits for
//       its last wgmmas.  So one warpgroup's epilogue runs while the
//       other's wgmmas run.
//     - cooperative (layer a at large batches, kLargeTilesPerSm): both
//       warpgroups take 64 rows each of one 128-row tile, so each W
//       k-block feeds 128 rows; layer a's epilogue is light (bf16 y only),
//       so little is lost by running it between mainloops.
//  - Tensor cores: wgmma.mma_async m64n256k16, bf16 x bf16 -> fp32, both
//    operands read from shared memory through 128-byte-swizzle
//    descriptors (trunk_sm90.cuh); a warpgroup's 64 x 256 fp32 sum is 128
//    registers a thread.  The head, 35 columns, takes 64 x 48 tiles
//    (m64n48k16).  A 64-wide k-block is 4 wgmmas; each k-block's group is
//    committed and the one before it waited for (wait_group 1), so the
//    tensor cores always have the next group queued.  A row's sums are the
//    same instructions in the same k order whatever schedule, tile, block
//    or batch takes it, so the output is bitwise that of the kernel this
//    one replaced.
//  - Operand loads: one thread of the producer warpgroup issues TMA loads
//    (cp.async.bulk.tensor, __grid_constant__ CUtensorMap descriptors
//    encoded on the host by each call) of the A (64 or 128 x 64) and W
//    (BN x 64) tiles into a ring of stages (3-5, 8 in the head), each
//    with a full and an empty mbarrier,
//    walking the block's tiles in the order the consumers take them.  It
//    runs ahead across tiles, so no mainloop starts from an empty ring,
//    and no block-wide barrier runs after set-up.  The producer warpgroup
//    gives up registers (setmaxnreg 40), the consumers take them (232).
//    TMA zero-fills rows past M and N (the ragged batch, the head's 35
//    rows, D = 64 under a 256-wide tile).  The prelude's A is the fp32
//    noise (K0 <= 256): each consumer warpgroup loads its tile's rows,
//    rounds them to bf16 and writes them into its own A buffer in the
//    swizzled layout TMA would write, while the other warpgroup's wgmmas
//    run, so the trunk needs no extra launch.
//  - Clusters (layer b at large batches): two blocks on neighbouring SMs
//    take the two 64-row tiles of a 128-row pair of one column tile: each
//    loads its own A and half of the W tile, multicast into both blocks'
//    shared memory, so a 64-row tile costs L2 no more W bytes than a
//    128-row tile of two warpgroups does.  A consumer warp frees a stage in
//    both blocks (the empty barrier counts 4 warps of each), with a release
//    at the scope of its own block: one at the cluster's scope also waits
//    for the warp's earlier epilogue stores, and made the layer twice as
//    slow.
//  - bf16 activations between layers: every activation whose next consumer
//    rounds it to bf16 is stored as bf16, rounded to nearest even in the
//    epilogue exactly as the next layer would round it (so the result is
//    the same function, not an approximation).  Layer a of each block
//    stores y as bf16 only; the prelude and layer b store h in fp32 (the
//    next block's residual) and its bf16 shadow (the next GEMM's A); the
//    last block skips the fp32 h, which nothing reads.
//  - Epilogue through shared memory and TMA (store_tile): a 32-column chunk
//    at a time, acc + fp32 bias (+ the fp32 residual) and ReLU go into a
//    chunk buffer in the swizzled layout of the output's tensor map, and one
//    thread stores the chunk by TMA; layer b's residual chunks arrive in the
//    same buffers by TMA, the first two while the tile's mainloop runs.  On
//    the card, 16-byte stores from registers made the epilogue outlast the
//    other warpgroup's mainloop: layer b took 0.39 ms and the prelude 0.23
//    ms at B = 65536, against 0.35 and 0.20 with TMA stores (loading the
//    residual by TMA rather than into registers measured the same, and
//    keeps every device-memory access of the epilogue on TMA).  The
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

enum Epilogue : int {
  kPrelude = 0,   // A = fp32 noise; relu; store fp32 h and its bf16 shadow
  kHidden = 1,    // relu; store bf16 y
  kResidual = 2,  // relu((acc + b) + h); store fp32 h (if asked) and the shadow
  kHead = 3,      // acc + b; store fp32 (B, N), masked
};

constexpr int BM = 64;                       // tile rows: one consumer warpgroup's wgmma
constexpr int kHiddenBN = 256;               // hidden layers' tile columns: m64n256k16
constexpr int kHeadBN = 48;                  // the head's 35 columns: m64n48k16
constexpr int BK = 64;                       // k-block: one 128-byte swizzled row
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileA = BM * BK * 2;          // 8 KB
constexpr int kMaxNoiseBlocks = 4;           // the prelude's K0 <= 4 k-blocks
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;           // dynamic shared memory a block may take
// A large batch: each SM walks more than this many 64-row tiles of a D x D
// layer.  There layer a's two warpgroups share 128-row tiles (cooperative:
// each W k-block feeds 128 rows) and layer b runs in clusters of two blocks
// that share each W k-block by multicast; both halve the W bytes a row
// takes from L2, which pace a long run of tiles.  Below it the cooperative
// tiles and the clusters' coupled rings cost more than they save.  Measured
// on an H100 (D = 1000): at B = 65536 (31 tiles an SM) the cooperative
// layer a took 0.205 ms against 0.221 in ping-pong and the last layer b
// 0.29 ms in clusters against 0.33; at 32768 (15.5) both alike; at 8192
// and 4096 the cooperative layer a 8% and 20% slower, clusters 4-20%.
constexpr int kLargeTilesPerSm = 16;
constexpr int kChunkCols = 32;               // columns of one TMA store box
constexpr int kStoreF32 = BM * kChunkCols * 4;  // 8 KB: a chunk's fp32 box
constexpr int kStoreBufs = 2;                // chunk buffers a consumer warpgroup
static_assert(kStoreBufs >= 2,
              "layer b loads a chunk's residual while the chunk before is stored");
constexpr int kNoiseBar = 1;                 // named barriers: + wg, a warpgroup's noise
constexpr int kTurnBar = 3;                  // + wg: this warpgroup's turn at the tensor cores
constexpr int kStoreBar = 5;                 // + wg: a warpgroup's staging buffers
constexpr int kTensorMapError = 0x10000;     // + the CUresult of a failed encode

// a ring stage: the A tile of a block tile of wgt x 64 rows (the prelude
// stages its own) and the W tile
__host__ __device__ constexpr int stage_bytes(int bn, int epi, int wgt) {
  return (epi == kPrelude ? 0 : wgt * kTileA) + bn * BK * 2;
}
// the prelude's A buffers, one a consumer warpgroup
__host__ __device__ constexpr int own_a_bytes(int epi) {
  return epi == kPrelude ? kConsumers * kMaxNoiseBlocks * kTileA : 0;
}
// The epilogue's staging: kStoreBufs chunk buffers a consumer warpgroup,
// each the chunk's fp32 box (none in layer a, which stores bf16 y only),
// then its bf16 box.
__host__ __device__ constexpr int f32_box_bytes(int epi) { return epi == kHidden ? 0 : kStoreF32; }
__host__ __device__ constexpr int chunk_buf_bytes(int epi) {
  return f32_box_bytes(epi) + BM * kChunkCols * 2;
}
__host__ __device__ constexpr int staging_bytes(int epi) {
  return epi == kHead ? 0 : kConsumers * kStoreBufs * chunk_buf_bytes(epi);
}
// the barriers (the ring's, and one a chunk buffer) and slack to align the
// ring to 1024 bytes
constexpr int kFixedBytes =
    (2 * kMaxStages + kConsumers * kStoreBufs) * 8 + static_cast<int>(dhtrunk::kAtomBytes);
// as many ring stages as the rest leaves room for, at most kMaxStages: 4 in
// layer b and the cooperative layer a, 5 in the ping-pong layer a, 3 in the
// prelude, 8 in the head
__host__ __device__ constexpr int ring_stages(int bn, int epi, int wgt) {
  return (kSmemLimit - kFixedBytes - own_a_bytes(epi) - staging_bytes(epi)) /
                     stage_bytes(bn, epi, wgt) <
                 kMaxStages
             ? (kSmemLimit - kFixedBytes - own_a_bytes(epi) - staging_bytes(epi)) /
                   stage_bytes(bn, epi, wgt)
             : kMaxStages;
}
// 209 KiB (217 KiB for the ping-pong layer a, 113 KiB for the head)
__host__ __device__ constexpr int smem_bytes(int bn, int epi, int wgt) {
  return ring_stages(bn, epi, wgt) * stage_bytes(bn, epi, wgt) + own_a_bytes(epi) +
         staging_bytes(epi) + kFixedBytes;
}

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

// arrive on the barrier at `bar` (a shared address of this block) in block
// `cta` of the cluster.  The release is the default one, at the scope of
// the block: a release at the cluster's scope would also wait for this
// thread's earlier global stores (the last epilogue's) to reach L2, which
// held each k-block of the mainloop and made the kernel twice as slow.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// TMA with multicast: the box lands at the same shared offset `dst` in each
// block of `mask`, completing the transaction bytes of each one's `bar`
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                      int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// TMA store: the box at (c0 = column, c1 = row) of `map` from shared `src`,
// in this thread's bulk group; rows and columns past the map's are dropped
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// two floats -> bf16x2, each rounded to nearest even; lo at the lower address
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The prelude's A: the 64 rows from m0 of the fp32 noise (K columns,
// K <= kMaxNoiseBlocks * BK), rounded to bf16 and written into a_tiles, one
// k-block after another, in the layout a TMA load with the 128-byte swizzle
// would give.  t is the thread in its warpgroup.
__device__ __forceinline__ void stage_noise(uint8_t* a_tiles, const float* __restrict__ noise,
                                            int m0, int t, int M, int K) {
  constexpr int kBatch = 16;  // float4 loads a thread keeps in flight: all of K = 128
  const int per_row = K / 4;  // float4 a row
  const int total = BM * per_row;
  for (int base = t; base < total; base += 128 * kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + 128 * u;
      const int m = m0 + idx / per_row;
      x[u] = idx < total && m < M
                 ? __ldg(reinterpret_cast<const float4*>(noise + static_cast<size_t>(m) * K +
                                                         4 * (idx % per_row)))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = base + 128 * u;
      if (idx < total) {
        const int r = idx / per_row;  // row in the tile
        const int c = 4 * (idx % per_row);
        *reinterpret_cast<uint2*>(a_tiles + (c / BK) * kTileA +
                                  dhtrunk::sw128_offset(r, (c % BK) * 2)) =
            make_uint2(pack_bf16x2(x[u].x, x[u].y), pack_bf16x2(x[u].z, x[u].w));
      }
    }
  }
}

// Layer b's residual chunk ch of the tile at (m0, n0), by TMA, into its
// buffer of this warpgroup's staging, completing that buffer's barrier
__device__ __forceinline__ void load_residual(const CUtensorMap* tm_f32, uint8_t* staging,
                                              uint32_t rbar0, int ch, int m0, int n0) {
  const uint32_t bar = rbar0 + 8 * (ch % kStoreBufs);
  mbar_expect_tx(bar, kStoreF32);
  tma_load_2d(smem_u32(staging + (ch % kStoreBufs) * chunk_buf_bytes(kResidual)), tm_f32,
              n0 + ch * kChunkCols, m0, bar);
}

// The epilogue of the 64 x BN tile at (m0, n0) whose sums thread t of
// warpgroup wg holds in wgmma's accumulator layout.
//  - The head: acc + bias, masked fp32 stores from that layout.
//  - The others, a 32-column chunk at a time: acc + bias (+ the fp32
//    residual, layer b), ReLU, then this thread's pairs into a chunk buffer
//    of this warpgroup's staging in the swizzled layout of the output maps
//    (fp32: 128-byte rows, bf16: 64-byte rows; no bank conflict beyond what
//    the bytes need), and one thread stores the chunk's boxes by TMA.  The
//    chunk buffers take turns; a buffer is written again once the store
//    from it has read it.  Layer b's residual chunks arrive in the fp32
//    half of the buffers by TMA (the first ones while the tile's mainloop
//    runs, the later ones as buffers come free), and the result overwrites
//    them in place; `rpar` holds the parity each buffer's barrier waits
//    for next.  No thread loads or stores device memory itself, so the
//    epilogue's traffic runs as deep as TMA takes it.
template <int BN, int EPI>
__device__ __forceinline__ void store_tile(float (&acc)[BN / 2], int m0, int n0, int t, int wg,
                                           const float* __restrict__ bias, float* out_f32,
                                           const CUtensorMap* tm_f32, const CUtensorMap* tm_bf16,
                                           uint8_t* staging, uint32_t rbar0, uint32_t& rpar,
                                           int M, int N) {
  if constexpr (EPI == kHead) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = m0 + dhtrunk::acc_row(t, i);
      const int c = n0 + dhtrunk::acc_col(t, i);
      if (r < M && c < N) out_f32[static_cast<size_t>(r) * N + c] = acc[i] + __ldg(bias + c);
    }
  } else {
    constexpr int kGroups = kChunkCols / 8;
    const int chunks = (N - n0 < BN ? N - n0 : BN) / kChunkCols;
    const int r_lo = dhtrunk::acc_row(t, 0);  // this thread's rows in the tile: r_lo, r_lo + 8
#pragma unroll
    for (int ch = 0; ch < BN / kChunkCols; ++ch) {
      if (ch >= chunks) break;  // the same for the whole warpgroup
      uint8_t* buf = staging + (ch % kStoreBufs) * chunk_buf_bytes(EPI);
      if constexpr (EPI == kResidual) {
        mbar_wait(rbar0 + 8 * (ch % kStoreBufs), (rpar >> (ch % kStoreBufs)) & 1);
        rpar ^= 1u << (ch % kStoreBufs);
      } else {
        if (t == 0) bulk_wait_read<kStoreBufs - 1>();
        named_sync(kStoreBar + wg, 128);
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int j = ch * kGroups + g;
        const int c = 8 * g + 2 * (t & 3);  // column in the chunk
        const float2 b = __ldg(reinterpret_cast<const float2*>(bias + n0 + ch * kChunkCols + c));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float2* slot =
              reinterpret_cast<float2*>(buf + dhtrunk::sw128_offset(r_lo + 8 * e, 4 * c));
          float x0 = acc[4 * j + 2 * e] + b.x, x1 = acc[4 * j + 2 * e + 1] + b.y;
          if constexpr (EPI == kResidual) {
            const float2 h = *slot;
            x0 += h.x;
            x1 += h.y;
          }
          x0 = fmaxf(x0, 0.f);
          x1 = fmaxf(x1, 0.f);
          if constexpr (EPI != kHidden) *slot = make_float2(x0, x1);
          *reinterpret_cast<uint32_t*>(buf + f32_box_bytes(EPI) +
                                       dhtrunk::sw64_offset(r_lo + 8 * e, 2 * c)) =
              pack_bf16x2(x0, x1);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
      named_sync(kStoreBar + wg, 128);
      if (t == 0) {
        if (EPI != kHidden && out_f32 != nullptr)
          tma_store_2d(tm_f32, smem_u32(buf), n0 + ch * kChunkCols, m0);
        tma_store_2d(tm_bf16, smem_u32(buf + f32_box_bytes(EPI)), n0 + ch * kChunkCols, m0);
        bulk_commit();
        if constexpr (EPI == kResidual) {
          // the store of the chunk before has read its buffer: the residual
          // kStoreBufs - 1 chunks ahead goes there
          if (ch >= 1 && ch - 1 + kStoreBufs < chunks) {
            bulk_wait_read<1>();
            load_residual(tm_f32, staging, rbar0, ch - 1 + kStoreBufs, m0, n0);
          }
        }
      }
    }
  }
}

// One layer, persistent: C = epilogue(A W^T + bias) over 64 WGT x BN
// tiles, WGT consumer warpgroups a tile (1: ping-pong, 2: cooperative).
// CL blocks a cluster share each k-block's W tile by multicast.
template <int BN, int EPI, int CL, int WGT>
__global__ void __launch_bounds__(kThreads, 1)
trunk_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_f32,
                  const __grid_constant__ CUtensorMap tm_bf16, const float* __restrict__ noise,
                  const float* __restrict__ bias, float* out_f32, int M, int N, int K) {
  static_assert(EPI == kHead || BN % 64 == 0, "the stores pair 8-column groups, 8 at a time");
  static_assert(CL == 1 || (EPI != kPrelude && (BN / CL) % 8 == 0),
                "a block's W slice is whole 8-row swizzle atoms; the prelude has no A to load");
  constexpr int S = ring_stages(BN, EPI, WGT);
  constexpr bool kPingPong = WGT == 1;
  constexpr int TM = BM * WGT;  // a block tile's rows
  constexpr int kStageA = EPI == kPrelude ? 0 : WGT * kTileA;
  constexpr int kStage = stage_bytes(BN, EPI, WGT);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment of the shared address
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t align = dhtrunk::kAtomBytes;
  uint8_t* smem = smem_raw + (((raw + align - 1) & ~(align - 1)) - raw);
  uint8_t* own_a = smem + S * kStage;
  uint8_t* staging = own_a + own_a_bytes(EPI);
  uint64_t* bars = reinterpret_cast<uint64_t*>(staging + staging_bytes(EPI));
  const uint32_t ring = smem_u32(smem);
  // the ring's full and empty barriers, then each warpgroup's residual buffers'
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * S, resid0 = empty0 + 8 * S;

  const int rank = CL == 1 ? 0 : static_cast<int>(cluster_rank());
  const int worker = blockIdx.x / CL, workers = gridDim.x / CL;
  const int mine = dhtrunk::worker_units(worker, workers, dhtrunk::unit_count(M, N, TM * CL, BN));
  const int kblocks = K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);        // the producer's expect_tx
      // the consuming warpgroups' warps, in each block
      mbar_init(empty0 + 8 * s, 4 * WGT * CL);
    }
    if (EPI == kResidual)  // each chunk buffer's residual load: its expect_tx
      for (int i = 0; i < kConsumers * kStoreBufs; ++i) mbar_init(resid0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (CL > 1) cluster_sync();  // the peer's barriers exist before anything signals them

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer warpgroup: one thread keeps the ring full, tile after tile;
    // the warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      for (int j = 0, s = 0, phase = 0; j < mine; ++j) {
        int m0, n0;
        dhtrunk::unit_origin(worker, workers, j, N, TM * CL, BN, &m0, &n0);
        m0 += rank * TM;
        for (int kb = 0; kb < kblocks; ++kb) {
          const uint32_t full = full0 + 8 * s, stage = ring + s * kStage;
          mbar_wait(empty0 + 8 * s, phase ^ 1);  // the first pass finds every stage free
          mbar_expect_tx(full, kStage);          // every block's W slice lands in each block
          if constexpr (EPI != kPrelude) tma_load_2d(stage, &tm_a, kb * BK, m0, full);
          if constexpr (CL == 1) {
            tma_load_2d(stage + kStageA, &tm_w, kb * BK, n0, full);
          } else {
            constexpr int kSlice = BN / CL;
            tma_load_2d_multicast(stage + kStageA + rank * kSlice * dhtrunk::kRowBytes, &tm_w,
                                  kb * BK, n0 + rank * kSlice, full, (1u << CL) - 1);
          }
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    // no block leaves while its peer may still multicast into it or free
    // its stages (each branch ends on its own: setmaxnreg wants the two
    // never to rejoin)
    if constexpr (CL > 1) cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const bool warp_leader = (t & 31) == 0;
    uint8_t* noise_tiles = own_a + wg * kMaxNoiseBlocks * kTileA;
    uint8_t* my_staging = staging + wg * kStoreBufs * chunk_buf_bytes(EPI);
    const uint32_t my_resid = resid0 + 8 * kStoreBufs * wg;
    uint32_t rpar = 0;  // the parity each residual buffer waits for next
    float acc[BN / 2];
    // frees stage s in every block of the cluster, once this warp's wgmmas
    // that read it are done
    auto release = [&](int s) {
      if (!warp_leader) return;
      if constexpr (CL == 1) {
        mbar_arrive(empty0 + 8 * s);
      } else {
#pragma unroll
        for (int c = 0; c < CL; ++c) mbar_arrive_cluster(empty0 + 8 * s, c);
      }
    };
    for (int j = kPingPong ? wg : 0; j < mine; j += kPingPong ? kConsumers : 1) {
      int m0, n0;
      dhtrunk::unit_origin(worker, workers, j, N, TM * CL, BN, &m0, &n0);
      m0 += rank * TM + (kPingPong ? 0 : wg * BM);  // this warpgroup's 64 rows
      if constexpr (EPI == kPrelude) {
        stage_noise(noise_tiles, noise, m0, t, M, K);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
        named_sync(kNoiseBar + wg, 128);                                // this warpgroup
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      // the tensor cores are this warpgroup's once the tile before this
      // one (the other warpgroup's) has issued its wgmmas
      if (kPingPong && j > 0) named_sync(kTurnBar + wg, 256);

      const int first = j * kblocks;  // this tile's first k-block in the ring's sequence
      int s = first % S, phase = (first / S) & 1;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full0 + 8 * s, phase);
        fence_acc(acc);
        wgmma_fence();
        const uint32_t a = EPI == kPrelude ? smem_u32(noise_tiles + kb * kTileA)
                                            : ring + s * kStage + (kPingPong ? 0 : wg * kTileA);
        const uint32_t b = ring + s * kStage + kStageA;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_k16(acc, dhtrunk::sw128_desc(a + 32 * kk), dhtrunk::sw128_desc(b + 32 * kk));
        wgmma_commit();
        if constexpr (EPI == kResidual) {
          if (kb == 0 && t == 0) {
            // the tile's first residual chunks load while its mainloop runs,
            // once the last tile's stores have read their buffers
            bulk_wait_read<0>();
            const int chunks = (N - n0 < BN ? N - n0 : BN) / kChunkCols;
            for (int ch = 0; ch < kStoreBufs && ch < chunks; ++ch)
              load_residual(&tm_f32, my_staging, my_resid, ch, m0, n0);
          }
        }
        wgmma_wait<1>();  // the previous k-block's group has finished reading its stage
        fence_acc(acc);
        if (kb > 0) release((s + S - 1) % S);
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      // the next tile of this block is the other warpgroup's: its turn
      if (kPingPong && j + 1 < mine) named_arrive(kTurnBar + (wg ^ 1), 256);
      wgmma_wait<0>();
      fence_acc(acc);
      release((s + S - 1) % S);
      store_tile<BN, EPI>(acc, m0, n0, t, wg, bias, out_f32, &tm_f32, &tm_bf16, my_staging,
                          my_resid, rpar, M, N);
    }
    // the stores have read shared memory (they complete with the grid)
    if (EPI != kHead && t == 0) bulk_wait_read<0>();
    if constexpr (CL > 1) cluster_sync();
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

// descriptor of a row-major (rows, cols) matrix of bf16 or fp32, moved in
// boxes of box_rows x box_cols with the given swizzle; out-of-bounds
// elements read as 0 and are not written
int encode_2d(EncodeTiled fn, CUtensorMap* map, const void* base, bool fp32, int rows, int cols,
              int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * (fp32 ? 4 : 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
         const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// an operand: bf16 boxes of box_rows x 64 (one k-block) with the 128-byte swizzle
int encode_operand(EncodeTiled fn, CUtensorMap* map, const void* base, int rows, int cols,
                   int box_rows) {
  return encode_2d(fn, map, base, false, rows, cols, box_rows, BK, CU_TENSOR_MAP_SWIZZLE_128B);
}

// an epilogue output: a chunk's box of 64 rows x 32 columns, fp32 in
// 128-byte rows or bf16 in 64-byte rows, each swizzled across its rows
int encode_output(EncodeTiled fn, CUtensorMap* map, const void* base, bool fp32, int rows,
                  int cols) {
  return encode_2d(fn, map, base, fp32, rows, cols, BM, kChunkCols,
                   fp32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// the SMs of the current device
int device_sms(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}

// The blocks a launch of trunk_gemm_kernel<BN, EPI, CL, WGT> takes for an
// M x N output: one a schedule unit, and at most as many as are resident
// at once (one block an SM; with clusters, as many clusters as fit).
template <int BN, int EPI, int CL, int WGT>
int layer_blocks(int M, int N, int* blocks) {
  // above 48 KB of dynamic shared memory needs the opt-in, once per kernel
  static const cudaError_t attr =
      cudaFuncSetAttribute(trunk_gemm_kernel<BN, EPI, CL, WGT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BN, EPI, WGT));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int resident = 0;
  if constexpr (CL == 1) {
    const int rc = device_sms(&resident);
    if (rc != 0) return rc;
  } else {
    static int clusters = 0;
    static const cudaError_t occ = [] {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute cluster[1];
      cluster[0].id = cudaLaunchAttributeClusterDimension;
      cluster[0].val.clusterDim.x = CL;
      cluster[0].val.clusterDim.y = 1;
      cluster[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(CL);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = smem_bytes(BN, EPI, WGT);
      cfg.attrs = cluster;
      cfg.numAttrs = 1;
      return cudaOccupancyMaxActiveClusters(&clusters, trunk_gemm_kernel<BN, EPI, CL, WGT>, &cfg);
    }();
    if (occ != cudaSuccess) return static_cast<int>(occ);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    resident = clusters;
  }
  const int units = dhtrunk::unit_count(M, N, BM * WGT * CL, BN);
  *blocks = CL * (units < resident ? units : resident);
  return 0;
}

template <int BN, int EPI, int CL, int WGT>
int launch_layer(const CUtensorMap& a, const CUtensorMap& w, const CUtensorMap& o32,
                 const CUtensorMap& o16, const float* noise, const void* bias, float* out_f32,
                 int M, int N, int K, cudaStream_t stream) {
  int blocks = 0;
  const int rc = layer_blocks<BN, EPI, CL, WGT>(M, N, &blocks);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = CL;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(BN, EPI, WGT);
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, trunk_gemm_kernel<BN, EPI, CL, WGT>, a, w, o32, o16, noise,
                         static_cast<const float*>(bias), out_f32, M, N, K);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The D x D layers' schedule at batch B: whether it is a large batch, and
// layer b's 64-row tiles and the blocks a launch of it takes.
int hidden_schedule(int B, int D, bool* large, int* tiles, int* blocks) {
  int sms = 0;
  const int rc = device_sms(&sms);
  if (rc != 0) return rc;
  *large = dhtrunk::unit_count(B, D, BM, kHiddenBN) > kLargeTilesPerSm * sms;
  if (*large) {
    *tiles = 2 * dhtrunk::unit_count(B, D, 2 * BM, kHiddenBN);
    return layer_blocks<kHiddenBN, kResidual, 2, 1>(B, D, blocks);
  }
  *tiles = dhtrunk::unit_count(B, D, BM, kHiddenBN);
  return layer_blocks<kHiddenBN, kResidual, 1, 1>(B, D, blocks);
}

// The three residual blocks' layers a and b; at a large batch layer a's
// warpgroups share 128-row tiles and layer b runs in clusters of two.
template <bool LARGE>
int residual_blocks(const CUtensorMap& t_hs, const CUtensorMap& t_y, const CUtensorMap* t_w,
                    const CUtensorMap& t_h_out, const CUtensorMap& t_hs_out,
                    const CUtensorMap& t_y_out, const void* const* params, float* h, int B, int D,
                    cudaStream_t s) {
  const CUtensorMap t_none = {};
  int rc = 0;
  for (int blk = 0; blk < 3 && rc == 0; ++blk) {
    const int p = 1 + 2 * blk;
    rc = launch_layer<kHiddenBN, kHidden, 1, LARGE ? 2 : 1>(
        t_hs, t_w[p], t_none, t_y_out, nullptr, params[2 * p + 1], nullptr, B, D, D, s);
    // the last block's fp32 h has no reader: the head reads the shadow
    if (rc == 0)
      rc = launch_layer<kHiddenBN, kResidual, LARGE ? 2 : 1, 1>(
          t_y, t_w[p + 1], t_h_out, t_hs_out, nullptr, params[2 * p + 3], blk < 2 ? h : nullptr,
          B, D, D, s);
  }
  return rc;
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
  if (K0 % BK != 0 || K0 > kMaxNoiseBlocks * BK || D % BK != 0 || O > kHeadBN)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = nullptr;
  int rc = tensor_map_encoder(&fn);
  bool large = false;
  int tiles = 0, blocks = 0;
  if (rc == 0) rc = hidden_schedule(B, D, &large, &tiles, &blocks);
  if (rc != 0) return rc;
  // tensor maps: the two bf16 activations as operands (A: the shadow in
  // layer a's 128-row and the head's 64-row tiles, y in layer b's) and as
  // outputs, fp32 h as an output (and layer b's residual), and the 8 weights
  // (W); a layer b block in a cluster loads its half of the W tile
  CUtensorMap t_hs_a, t_hs, t_y, t_h_out, t_hs_out, t_y_out, t_w[8];
  const CUtensorMap t_none = {};  // the prelude stages its A itself; the head stores its own
  rc = encode_operand(fn, &t_hs_a, hs, B, D, large ? 2 * BM : BM);
  if (rc == 0) rc = encode_operand(fn, &t_hs, hs, B, D, BM);
  if (rc == 0) rc = encode_operand(fn, &t_y, y, B, D, BM);
  if (rc == 0) rc = encode_output(fn, &t_h_out, h, true, B, D);
  if (rc == 0) rc = encode_output(fn, &t_hs_out, hs, false, B, D);
  if (rc == 0) rc = encode_output(fn, &t_y_out, y, false, B, D);
  for (int i = 0; i < 8 && rc == 0; ++i) {
    const int n = i == 7 ? O : D, k = i == 0 ? K0 : D;
    const bool layer_b = i > 0 && i < 7 && i % 2 == 0;
    const int box = i == 7 ? kHeadBN : layer_b && large ? kHiddenBN / 2 : kHiddenBN;
    rc = encode_operand(fn, &t_w[i], params[2 * i], n, k, box);
  }
  if (rc != 0) return rc;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hp = static_cast<float*>(h);
  rc = launch_layer<kHiddenBN, kPrelude, 1, 1>(t_none, t_w[0], t_h_out, t_hs_out,
                                            static_cast<const float*>(noise), params[1], hp, B, D,
                                            K0, s);
  if (rc == 0)
    rc = large ? residual_blocks<true>(t_hs_a, t_y, t_w, t_h_out, t_hs_out, t_y_out, params, hp,
                                       B, D, s)
               : residual_blocks<false>(t_hs_a, t_y, t_w, t_h_out, t_hs_out, t_y_out, params, hp,
                                        B, D, s);
  if (rc == 0)
    rc = launch_layer<kHeadBN, kHead, 1, 1>(t_hs, t_w[7], t_none, t_none, nullptr, params[15],
                                         static_cast<float*>(out), B, O, D, s);
  return rc;
}

// The schedule dhtrunk_forward gives each residual block's layer b at
// batch B on the current device: the 64-row tiles it computes and the
// blocks it launches for them.  Returns a cudaError_t, 0 on success.
extern "C" int dhtrunk_schedule(int B, int D, int* tiles, int* blocks) {
  bool large = false;
  *tiles = *blocks = 0;
  return B > 0 ? hidden_schedule(B, D, &large, tiles, blocks) : 0;
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
