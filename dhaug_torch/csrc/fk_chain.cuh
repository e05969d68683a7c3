// DH forward kinematics and its VJP, phase by phase over a tile of poses.
// Shared by the CUDA kernels (fk_kernels.cu) and by a host driver at the end
// of this file, which g++ builds in the CPU tests (with __host__/__device__
// defined empty): the host runs the same phase functions in the kernels'
// order, one loop per phase where a kernel has __syncthreads, so the kernels'
// arithmetic is checked before the card ever runs it.
//
// Conventions are those of dhaug_torch/ops/fk.py: 33 angles in degrees packed
// [right_leg(5), left_leg(5), body(13), right_hand(5), left_hand(5)] (the
// packed angle index is also the link's index), 15 bone lengths in FK order,
// XYZ Euler global rotation in degrees, root in metres; the output is the
// 16-joint pose.
//
// Chain recurrence:   p_i = p_{i-1} + R_{i-1} t_i,   R_i = R_{i-1} Q_i,
// with Q_i = Rx(alpha_i) Rz(theta_i).  The arm chains start from body link 8.
//
// A block takes kTile consecutive poses, one a lane; each job (a chain walk,
// or the global gradients) has a warp.  Each phase is a function of (tile,
// item) or (tile, job, pose):
//   forward:  load -> trig -> chains (one job a chain; each writes its joints'
//             world coordinates) -> store
//   backward: load -> trig -> chains -> reverse chains + global rotation and
//             root -> store
// The backward is the revolute-joint Jacobian, with no dR recurrence.  With
// u_k = Rg^T g_k for output joint k, and sums over the joints k at or after
// link i (for body links 0-8 the arms' joints too):
//   U_i = sum u_k,  W_i = sum (p_k - p_i) x u_k = W_{i+1} + (p_{i+1} - p_i) x U_{i+1}
//   dtheta_i = kDeg z_i . W_i, z_i = R_i[:, 2];   dt_i = R_{i-1}^T U_i
//   dRg = sum g_k (x) p_k,   droot = sum g_k.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define DHFK_TABLE __constant__
#else
#define DHFK_TABLE
#endif

namespace dhfk {

constexpr float kDeg = 0.017453292519943295f;  // pi / 180
// cos(+-90 deg) as float32, as the reference computes it (cos in double,
// rounded to float): tiny, not zero.
constexpr float kCos90 = 6.123234e-17f;

// Theta offsets (degrees) of the 33 links in packed order: ops/fk.py's
// *_THETA tables.  In constant memory: the trig phase reads it at one index
// a warp.
static DHFK_TABLE float kTheta0[33] = {
    0.f, -90.f, 180.f, 0.f, 0.f,                                           // right leg
    180.f, -90.f, 0.f, 0.f, 0.f,                                           // left leg
    90.f, -90.f, -90.f, -90.f, -90.f, -90.f, -90.f, -90.f, -90.f, -90.f,  // body
    -90.f, 0.f, 0.f,
    -180.f, -90.f, 180.f, 0.f, 0.f,                                        // right hand
    0.f, -90.f, 0.f, 0.f, 0.f};                                            // left hand

// One kinematic chain of L links, all compile-time constants.
template <int L>
struct ChainSpec {
  int angle0;     // index of the chain's first angle in the packed 33
  float ca[L];    // cos(alpha)
  float sa[L];    // sin(alpha)
  int a_bone[L];  // a = a_sign * bone_len[a_bone]; -1: a = 0
  float a_sign[L];
  int d_bone[L];  // d = bone_len[d_bone]; -1: d = 0
  int slot[L];    // 16-joint output slot of the link's endpoint; -1: none
};

// alpha = 0 -> (1, 0); alpha = +-90 -> (kCos90, +-1).
__host__ __device__ constexpr ChainSpec<5> right_leg() {
  return {0,
          {1.f, kCos90, kCos90, 1.f, 1.f},
          {0.f, -1.f, -1.f, 0.f, 0.f},
          {5, -1, -1, 3, 1},
          {1.f, 1.f, 1.f, 1.f, 1.f},
          {-1, -1, -1, -1, -1},
          {1, -1, -1, 2, 3}};
}

__host__ __device__ constexpr ChainSpec<5> left_leg() {
  return {5,
          {1.f, kCos90, kCos90, 1.f, 1.f},
          {0.f, 1.f, 1.f, 0.f, 0.f},
          {4, -1, -1, 2, 0},
          {-1.f, 1.f, 1.f, 1.f, 1.f},  // a0 = -left_hip
          {-1, -1, -1, -1, -1},
          {4, -1, -1, 5, 6}};
}

__host__ __device__ constexpr ChainSpec<13> body() {
  return {10,
          {1.f, kCos90, kCos90, kCos90, kCos90, kCos90, kCos90,
           kCos90, kCos90, kCos90, kCos90, kCos90, kCos90},
          {0.f, -1.f, -1.f, -1.f, -1.f, -1.f, -1.f,
           -1.f, -1.f, -1.f, -1.f, -1.f, 1.f},
          {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 14},
          {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f},
          {-1, -1, -1, 6, -1, -1, 7, -1, -1, -1, -1, -1, -1},
          {0, -1, -1, 7, -1, -1, 8, -1, -1, -1, -1, -1, 9}};
}

__host__ __device__ constexpr ChainSpec<5> right_hand() {
  return {23,
          {kCos90, kCos90, kCos90, 1.f, 1.f},
          {-1.f, -1.f, -1.f, 0.f, 0.f},
          {9, -1, -1, 11, 13},
          {-1.f, 1.f, 1.f, 1.f, 1.f},  // a0 = -right_shoulder
          {-1, -1, -1, -1, -1},
          {13, -1, -1, 14, 15}};
}

__host__ __device__ constexpr ChainSpec<5> left_hand() {
  return {28,
          {kCos90, kCos90, kCos90, 1.f, 1.f},
          {-1.f, 1.f, 1.f, 0.f, 0.f},
          {8, -1, -1, 10, 12},
          {1.f, 1.f, 1.f, 1.f, 1.f},
          {-1, -1, -1, -1, -1},
          {10, -1, -1, 11, 12}};
}

// ---------------------------------------------------------------------------
// 3x3 algebra on row-major float[9]
// ---------------------------------------------------------------------------

__host__ __device__ inline void rot_apply(const float* R, const float* v, float* out) {
  out[0] = R[0] * v[0] + R[1] * v[1] + R[2] * v[2];
  out[1] = R[3] * v[0] + R[4] * v[1] + R[5] * v[2];
  out[2] = R[6] * v[0] + R[7] * v[1] + R[8] * v[2];
}

__host__ __device__ inline void rot_T_apply(const float* R, const float* v, float* out) {
  out[0] = R[0] * v[0] + R[3] * v[1] + R[6] * v[2];
  out[1] = R[1] * v[0] + R[4] * v[1] + R[7] * v[2];
  out[2] = R[2] * v[0] + R[5] * v[1] + R[8] * v[2];
}

// C = A B
__host__ __device__ inline void rot_mul(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// ---------------------------------------------------------------------------
// The tile
// ---------------------------------------------------------------------------

constexpr int kTile = 32;      // poses a block, one a lane
constexpr int kThreads = 512;  // threads a block
constexpr int kChains = 5;     // jobs 0-4 walk a chain; job kChains: global gradients
constexpr int kTrig = 36;      // (cos, sin) a pose: 33 links, then 3 Euler angles
constexpr int kLinkFloats = 12;        // cumulative R (row-major) and p of a link
constexpr int kArmStartLink = 10 + 8;  // body link 8 in the packed link order
// Per-pose strides of the arrays a job's lanes touch at one offset each: odd,
// so a warp's 32 lanes fall in 32 banks.
constexpr int kGStride = 16 * 3 + 1;
constexpr int kLinkStride = 33 * kLinkFloats + 1;
// The output tile's rows: 16-byte aligned for vector stores, 4-way conflicts
// at most on the chain jobs' writes.
constexpr int kOutStride = 16 * 3 + 4;
static_assert(kTile == 32 && kThreads >= 32 * (kChains + 1), "a warp a job, a lane a pose");

// ang, bl, grot, root: the tile's rows as the row-major (B, n) inputs hold
// them; ct, st: k-major, [k * kTile + pose].
struct FwdTile {
  alignas(16) float ang[kTile * 33];
  alignas(16) float bl[kTile * 15];
  alignas(16) float grot[kTile * 3];
  alignas(16) float root[kTile * 3];
  alignas(16) float ct[kTrig * kTile];
  alignas(16) float st[kTrig * kTile];
  alignas(16) float out[kTile * kOutStride];  // world joint positions
};

struct BwdTile {
  alignas(16) float ang[kTile * 33];
  alignas(16) float bl[kTile * 15];
  alignas(16) float grot[kTile * 3];
  alignas(16) float g[kTile * kGStride];
  alignas(16) float ct[kTrig * kTile];
  alignas(16) float st[kTrig * kTile];
  alignas(16) float link[kTile * kLinkStride];
  alignas(16) float dang[kTile * 33];
  alignas(16) float dbl[kTile * 15];
  alignas(16) float dgrot[kTile * 3];
  alignas(16) float droot[kTile * 3];
};

#ifdef __CUDACC__
using Vec4 = float4;
#else
struct alignas(16) Vec4 { float x, y, z, w; };
#endif

// Global -> shared copies of 16 and 4 bytes: asynchronous on the card
// (cp.async, so a thread's loads of every array are in flight at once, and
// copy_wait() waits for them), plain assignments on the host.
__device__ inline void copy16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(__cvta_generic_to_global(src)));
#else
  *reinterpret_cast<Vec4*>(dst) = *reinterpret_cast<const Vec4*>(src);
#endif
}

__device__ inline void copy4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(__cvta_generic_to_global(src)));
#else
  *dst = *src;
#endif
}

__device__ inline void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Thread tid of nthreads copies its share of n floats from global to shared
// memory: 16-byte pieces when both ends are 16-byte aligned (then a scalar
// tail), else 4-byte ones.  Either way neighbouring threads touch
// neighbouring addresses.
__device__ inline void load_span(float* dst, const float* src, int n, int tid, int nthreads) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nthreads) copy16(dst + 4 * i, src + 4 * i);
    for (int i = 4 * n4 + tid; i < n; i += nthreads) copy4(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += nthreads) copy4(dst + i, src + i);
  }
}

// The same for `rows` packed rows of `width` floats, to rows `stride` apart.
__device__ inline void load_rows(float* dst, int stride, const float* src, int width, int rows,
                                 int tid, int nthreads) {
  for (int i = tid; i < rows * width; i += nthreads) {
    const int r = i / width;
    copy4(dst + r * stride + i - r * width, src + i);
  }
}

// Shared -> global: 16-byte stores when both ends are aligned, else 4-byte.
__device__ inline void store_span(float* dst, const float* src, int n, int tid, int nthreads) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nthreads)
      reinterpret_cast<Vec4*>(dst)[i] = reinterpret_cast<const Vec4*>(src)[i];
    for (int i = 4 * n4 + tid; i < n; i += nthreads) dst[i] = src[i];
  } else {
    for (int i = tid; i < n; i += nthreads) dst[i] = src[i];
  }
}

// Phase 0: the n poses from pose `base` on.
template <class Tile>
__device__ inline void load_common(Tile& t, const float* ang, const float* bl, const float* grot,
                                   size_t base, int n, int tid, int nthreads) {
  load_span(t.ang, ang + 33 * base, 33 * n, tid, nthreads);
  load_span(t.bl, bl + 15 * base, 15 * n, tid, nthreads);
  load_span(t.grot, grot + 3 * base, 3 * n, tid, nthreads);
}

__device__ inline void load_fwd(FwdTile& t, const float* ang, const float* bl,
                                const float* grot, const float* root, size_t base, int n,
                                int tid, int nthreads) {
  load_common(t, ang, bl, grot, base, n, tid, nthreads);
  load_span(t.root, root + 3 * base, 3 * n, tid, nthreads);
  copy_wait();
}

__device__ inline void load_bwd(BwdTile& t, const float* ang, const float* bl,
                                const float* grot, const float* g, size_t base, int n,
                                int tid, int nthreads) {
  load_common(t, ang, bl, grot, base, n, tid, nthreads);
  load_rows(t.g, kGStride, g + 48 * base, 48, n, tid, nthreads);
  copy_wait();
}

// ---------------------------------------------------------------------------
// Phase 1: trig
// ---------------------------------------------------------------------------

// sin and cos of x, from double precision rounded to float: within half an
// ulp of float but for the rarest ties, so at least as precise as sinf and
// cosf.  x is reduced by pi/2 in two fma steps (exact to ~1e-16 for
// |x| < 1e5), then Taylor polynomials on [-pi/4, pi/4] (truncation below
// 4e-13).  Unlike sinf/cosf it has no slow path for huge arguments, whose
// local array costs the kernels a stack frame; |x| beyond ~1e5 radians
// loses accuracy.
__device__ inline void precise_sincos(float x, float& s, float& c) {
  const double xd = x;
  const double q = rint(xd * 0.63661977236758134);  // 2 / pi
  double r = fma(-q, 1.5707963267948966, xd);        // pi / 2, rounded
  r = fma(-q, 6.123233995736766e-17, r);             // and its remainder
  const double r2 = r * r;
  double ps = fma(r2, 1.0 / 6227020800.0, -1.0 / 39916800.0);
  ps = fma(ps, r2, 1.0 / 362880.0);
  ps = fma(ps, r2, -1.0 / 5040.0);
  ps = fma(ps, r2, 1.0 / 120.0);
  ps = fma(ps, r2, -1.0 / 6.0);
  ps = fma(ps * r2, r, r);
  double pc = fma(r2, 1.0 / 479001600.0, -1.0 / 3628800.0);
  pc = fma(pc, r2, 1.0 / 40320.0);
  pc = fma(pc, r2, -1.0 / 720.0);
  pc = fma(pc, r2, 1.0 / 24.0);
  pc = fma(pc, r2, -0.5);
  pc = fma(pc, r2, 1.0);
  const int iq = static_cast<int>(q);
  const double sv = (iq & 1) ? pc : ps, cv = (iq & 1) ? ps : pc;
  s = static_cast<float>((iq & 2) ? -sv : sv);
  c = static_cast<float>(((iq + 1) & 2) ? -cv : cv);
}

// (cos, sin) number `item` = k kTile + pose, of exactly the argument the
// plain FK forms: (angle + theta offset) in degrees times kDeg for a link
// (k < 33), the Euler angle times kDeg after.
template <class Tile>
__device__ inline void trig_item(Tile& t, int item) {
  const int k = item / kTile, pose = item - k * kTile;
  const float x = k < 33 ? (t.ang[33 * pose + k] + kTheta0[k]) * kDeg
                         : t.grot[3 * pose + k - 33] * kDeg;
  precise_sincos(x, t.st[item], t.ct[item]);
}

// ---------------------------------------------------------------------------
// Chain walks from a pose's trig (ct, st: the tile's, offset by the pose)
// ---------------------------------------------------------------------------

// One DH link: rotation block Q and translation t.
template <int L>
__device__ inline void link_qt(const ChainSpec<L>& s, int i, const float* ct,
                               const float* st, const float* bl, float* Q, float* t) {
  const float c = ct[kTile * (s.angle0 + i)], sn = st[kTile * (s.angle0 + i)];
  const float ca = s.ca[i], sa = s.sa[i];
  Q[0] = c;       Q[1] = -sn;     Q[2] = 0.f;
  Q[3] = sn * ca; Q[4] = c * ca;  Q[5] = -sa;
  Q[6] = sn * sa; Q[7] = c * sa;  Q[8] = ca;
  const float a = s.a_bone[i] >= 0 ? s.a_sign[i] * bl[s.a_bone[i]] : 0.f;
  const float d = s.d_bone[i] >= 0 ? bl[s.d_bone[i]] : 0.f;
  t[0] = a;
  t[1] = -sa * d;
  t[2] = ca * d;
}

// Links [0, N) of a chain.  On entry (R, p) hold the start frame when
// HAS_START.  visit(s, i, R, p) sees the cumulative frame after link i.
template <int L, int N, bool HAS_START, class Visit>
__device__ inline void walk(const ChainSpec<L>& s, const float* ct, const float* st,
                            const float* bl, float* R, float* p, Visit visit) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float Q[9], t[3];
    link_qt(s, i, ct, st, bl, Q, t);
    if (!HAS_START && i == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Q[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = t[k];
    } else {
      float Rt[3], Rn[9];
      rot_apply(R, t, Rt);
      p[0] += Rt[0];
      p[1] += Rt[1];
      p[2] += Rt[2];
      rot_mul(R, Q, Rn);
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = Rn[k];
    }
    visit(s, i, R, p);
  }
}

// A whole chain; an arm first walks body links 0-8 itself, so no chain job
// waits for another.
template <int L, bool ARM, class Visit>
__device__ inline void walk_chain(const ChainSpec<L>& s, const float* ct, const float* st,
                                  const float* bl, Visit visit) {
  float R[9], p[3];
  if constexpr (ARM) {
    constexpr ChainSpec<13> bd = body();
    walk<13, 9, false>(bd, ct, st, bl, R, p, [](const ChainSpec<13>&, int, const float*,
                                                  const float*) {});
    walk<L, L, true>(s, ct, st, bl, R, p, visit);
  } else {
    walk<L, L, false>(s, ct, st, bl, R, p, visit);
  }
}

// Chain job (0 right leg, 1 left leg, 2 body, 3 right hand, 4 left hand) of
// one pose: ct, st and bl are the tile's, offset by the pose.
template <class Visit>
__device__ inline void chain_job(int job, const float* ct, const float* st, const float* bl,
                                 Visit visit) {
  switch (job) {
    case 0: { constexpr ChainSpec<5> s = right_leg(); walk_chain<5, false>(s, ct, st, bl, visit); break; }
    case 1: { constexpr ChainSpec<5> s = left_leg(); walk_chain<5, false>(s, ct, st, bl, visit); break; }
    case 2: { constexpr ChainSpec<13> s = body(); walk_chain<13, false>(s, ct, st, bl, visit); break; }
    case 3: { constexpr ChainSpec<5> s = right_hand(); walk_chain<5, true>(s, ct, st, bl, visit); break; }
    default: { constexpr ChainSpec<5> s = left_hand(); walk_chain<5, true>(s, ct, st, bl, visit); break; }
  }
}

// visit(slot, link) for every output joint, in chain order.
template <int L, class Visit>
__device__ inline void joints_of(const ChainSpec<L>& s, Visit& visit) {
#pragma unroll
  for (int i = 0; i < L; ++i)
    if (s.slot[i] >= 0) visit(s.slot[i], s.angle0 + i);
}

// Global rotation Rx @ Ry @ Rz of `pose` from the tile's Euler (cos, sin);
// with non-null d{x,y,z} also its partials with respect to each angle
// (radians).
template <class Tile>
__device__ inline void euler_xyz(const Tile& t, int pose, float* Rg, float* dx, float* dy,
                                 float* dz) {
  const float cx = t.ct[33 * kTile + pose], sx = t.st[33 * kTile + pose];
  const float cy = t.ct[34 * kTile + pose], sy = t.st[34 * kTile + pose];
  const float cz = t.ct[35 * kTile + pose], sz = t.st[35 * kTile + pose];
  Rg[0] = cy * cz;                 Rg[1] = -cy * sz;                Rg[2] = sy;
  Rg[3] = sx * sy * cz + cx * sz;  Rg[4] = -sx * sy * sz + cx * cz; Rg[5] = -sx * cy;
  Rg[6] = -cx * sy * cz + sx * sz; Rg[7] = cx * sy * sz + sx * cz;  Rg[8] = cx * cy;
  if (dx == nullptr) return;
  dx[0] = 0.f;                     dx[1] = 0.f;                     dx[2] = 0.f;
  dx[3] = cx * sy * cz - sx * sz;  dx[4] = -cx * sy * sz - sx * cz; dx[5] = -cx * cy;
  dx[6] = sx * sy * cz + cx * sz;  dx[7] = -sx * sy * sz + cx * cz; dx[8] = -sx * cy;
  dy[0] = -sy * cz;                dy[1] = sy * sz;                 dy[2] = cy;
  dy[3] = sx * cy * cz;            dy[4] = -sx * cy * sz;           dy[5] = sx * sy;
  dy[6] = -cx * cy * cz;           dy[7] = cx * cy * sz;            dy[8] = -cx * sy;
  dz[0] = -cy * sz;                dz[1] = -cy * cz;                dz[2] = 0.f;
  dz[3] = -sx * sy * sz + cx * cz; dz[4] = -sx * sy * cz - cx * sz; dz[5] = 0.f;
  dz[6] = cx * sy * sz + sx * cz;  dz[7] = cx * sy * cz - sx * sz;  dz[8] = 0.f;
}

// ---------------------------------------------------------------------------
// Forward phases
// ---------------------------------------------------------------------------

// Phase 2: chain `job` of `pose`; its output joints' world positions,
// Rg p + root.
__device__ inline void fwd_chain_item(FwdTile& t, int job, int pose) {
  float Rg[9];
  euler_xyz(t, pose, Rg, nullptr, nullptr, nullptr);
  const float* root = t.root + 3 * pose;
  float* out = t.out + kOutStride * pose;
  chain_job(job, t.ct + pose, t.st + pose, t.bl + 15 * pose,
            [&](const auto& s, int i, const float*, const float* p) {
    if (s.slot[i] >= 0) {
      float w[3];
      rot_apply(Rg, p, w);
      out[3 * s.slot[i] + 0] = w[0] + root[0];
      out[3 * s.slot[i] + 1] = w[1] + root[1];
      out[3 * s.slot[i] + 2] = w[2] + root[2];
    }
  });
}

// Phase 3: the tile's poses to the (B, 16, 3) output: 16-byte stores, 12 a
// pose, when `out` is 16-byte aligned, else 4-byte ones.
__device__ inline void store_fwd(const FwdTile& t, float* out, size_t base, int n, int tid,
                                 int nthreads) {
  float* dst = out + 48 * base;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int i = tid; i < 12 * n; i += nthreads) {
      const int r = i / 12;
      reinterpret_cast<Vec4*>(dst)[i] =
          *reinterpret_cast<const Vec4*>(t.out + kOutStride * r + 4 * (i - 12 * r));
    }
  } else {
    for (int i = tid; i < 48 * n; i += nthreads) {
      const int r = i / 48;
      dst[i] = t.out[kOutStride * r + i - 48 * r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward phases
// ---------------------------------------------------------------------------

// Phase 2: chain `job` of `pose`; every link's cumulative (R, p).
__device__ inline void bwd_chain_item(BwdTile& t, int job, int pose) {
  float* lk = t.link + kLinkStride * pose;
  chain_job(job, t.ct + pose, t.st + pose, t.bl + 15 * pose,
            [lk](const auto& s, int i, const float* R, const float* p) {
    float* f = lk + kLinkFloats * (s.angle0 + i);
#pragma unroll
    for (int k = 0; k < 9; ++k) f[k] = R[k];
    f[9] = p[0];
    f[10] = p[1];
    f[11] = p[2];
  });
}

__device__ inline void cross_add(const float* a, const float* b, float* acc) {
  acc[0] += a[1] * b[2] - a[2] * b[1];
  acc[1] += a[2] * b[0] - a[0] * b[2];
  acc[2] += a[0] * b[1] - a[1] * b[0];
}

// Phase 3a: one chain's angle and bone gradients, from its last link back;
// a joint's cotangent enters in the chain frame, u = Rg^T g.
template <int L, bool ARM, bool BODY>
__device__ inline void reverse_chain(const ChainSpec<L>& s, BwdTile& t, int pose) {
  const float* lk = t.link + kLinkStride * pose;
  const float* g = t.g + kGStride * pose;
  float Rg[9];
  euler_xyz(t, pose, Rg, nullptr, nullptr, nullptr);
  float* dang = t.dang + 33 * pose;
  float* dbl = t.dbl + 15 * pose;
  float U[3] = {0.f, 0.f, 0.f};  // sum of u over the joints at or after link i
  float W[3] = {0.f, 0.f, 0.f};  // sum of (p_k - p_i) x u_k over them
#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    const float* Ri = lk + kLinkFloats * (s.angle0 + i);
    const float* pi = Ri + 9;
    if (i < L - 1) {  // move the moment from p_{i+1} to p_i
      const float* pn = Ri + kLinkFloats + 9;
      const float d[3] = {pn[0] - pi[0], pn[1] - pi[1], pn[2] - pi[2]};
      cross_add(d, U, W);
    }
    if (s.slot[i] >= 0) {
      float us[3];
      rot_T_apply(Rg, g + 3 * s.slot[i], us);
      U[0] += us[0];
      U[1] += us[1];
      U[2] += us[2];
    }
    if constexpr (BODY) {
      if (i == kArmStartLink - 10) {  // the arms hang from body link 8
        auto arm = [&](int slot, int link) {
          const float* pk = lk + kLinkFloats * link + 9;
          float uk[3];
          rot_T_apply(Rg, g + 3 * slot, uk);
          const float d[3] = {pk[0] - pi[0], pk[1] - pi[1], pk[2] - pi[2]};
          cross_add(d, uk, W);
          U[0] += uk[0];
          U[1] += uk[1];
          U[2] += uk[2];
        };
        constexpr ChainSpec<5> rh = right_hand();
        constexpr ChainSpec<5> lh = left_hand();
        joints_of(rh, arm);
        joints_of(lh, arm);
      }
    }
    dang[s.angle0 + i] = kDeg * (Ri[2] * W[0] + Ri[5] * W[1] + Ri[8] * W[2]);
    float dt[3];
    if (i > 0) {
      rot_T_apply(Ri - kLinkFloats, U, dt);
    } else if constexpr (ARM) {
      rot_T_apply(lk + kLinkFloats * kArmStartLink, U, dt);
    } else {
      dt[0] = U[0];
      dt[1] = U[1];
      dt[2] = U[2];
    }
    // t = (a, -sa d, ca d); a = a_sign * bone, d = bone
    if (s.a_bone[i] >= 0) dbl[s.a_bone[i]] = s.a_sign[i] * dt[0];
    if (s.d_bone[i] >= 0) dbl[s.d_bone[i]] = -s.sa[i] * dt[1] + s.ca[i] * dt[2];
  }
}

// Phase 3b: global rotation and root gradients of `pose`.
__device__ inline void bwd_global_item(BwdTile& t, int pose) {
  const float* lk = t.link + kLinkStride * pose;
  const float* g = t.g + kGStride * pose;
  float Rg[9], dx[9], dy[9], dz[9];
  euler_xyz(t, pose, Rg, dx, dy, dz);
  float dRg[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float droot[3] = {0.f, 0.f, 0.f};
  auto acc = [&](int slot, int link) {
    const float* p = lk + kLinkFloats * link + 9;
    const float* gs = g + 3 * slot;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      droot[r] += gs[r];
#pragma unroll
      for (int c = 0; c < 3; ++c) dRg[3 * r + c] += gs[r] * p[c];
    }
  };
  constexpr ChainSpec<5> rl = right_leg();
  constexpr ChainSpec<5> ll = left_leg();
  constexpr ChainSpec<13> bd = body();
  constexpr ChainSpec<5> rh = right_hand();
  constexpr ChainSpec<5> lh = left_hand();
  joints_of(rl, acc);
  joints_of(ll, acc);
  joints_of(bd, acc);
  joints_of(rh, acc);
  joints_of(lh, acc);
  float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    cx += dRg[k] * dx[k];
    cy += dRg[k] * dy[k];
    cz += dRg[k] * dz[k];
  }
  t.dgrot[3 * pose + 0] = cx * kDeg;
  t.dgrot[3 * pose + 1] = cy * kDeg;
  t.dgrot[3 * pose + 2] = cz * kDeg;
  t.droot[3 * pose + 0] = droot[0];
  t.droot[3 * pose + 1] = droot[1];
  t.droot[3 * pose + 2] = droot[2];
}

// Phase 3: job 0-4 reverses a chain, job kChains takes the global gradients.
__device__ inline void bwd_reverse_item(BwdTile& t, int job, int pose) {
  switch (job) {
    case 0: { constexpr ChainSpec<5> s = right_leg(); reverse_chain<5, false, false>(s, t, pose); break; }
    case 1: { constexpr ChainSpec<5> s = left_leg(); reverse_chain<5, false, false>(s, t, pose); break; }
    case 2: { constexpr ChainSpec<13> s = body(); reverse_chain<13, false, true>(s, t, pose); break; }
    case 3: { constexpr ChainSpec<5> s = right_hand(); reverse_chain<5, true, false>(s, t, pose); break; }
    case 4: { constexpr ChainSpec<5> s = left_hand(); reverse_chain<5, true, false>(s, t, pose); break; }
    default: bwd_global_item(t, pose); break;
  }
}

// Phase 4: the tile's gradients back to the (B, n) outputs.
__device__ inline void store_bwd(const BwdTile& t, float* dang, float* dbl, float* dgrot,
                                 float* droot, size_t base, int n, int tid, int nthreads) {
  store_span(dang + 33 * base, t.dang, 33 * n, tid, nthreads);
  store_span(dbl + 15 * base, t.dbl, 15 * n, tid, nthreads);
  store_span(dgrot + 3 * base, t.dgrot, 3 * n, tid, nthreads);
  store_span(droot + 3 * base, t.droot, 3 * n, tid, nthreads);
}

// ---------------------------------------------------------------------------
// Host driver: the kernels' phases in their order, one loop per phase; a
// loop boundary stands where a kernel has __syncthreads.
// ---------------------------------------------------------------------------
#ifndef __CUDACC__

inline void fk_forward_host(const float* ang, const float* bl, const float* grot,
                            const float* root, float* out, int B) {
  static FwdTile t;
  for (int base = 0; base < B; base += kTile) {
    const int n = B - base < kTile ? B - base : kTile;
    for (int tid = 0; tid < kThreads; ++tid) load_fwd(t, ang, bl, grot, root, base, n, tid, kThreads);
    for (int it = 0; it < kTrig * kTile; ++it)
      if (it % kTile < n) trig_item(t, it);
    for (int job = 0; job < kChains; ++job)
      for (int pose = 0; pose < n; ++pose) fwd_chain_item(t, job, pose);
    for (int tid = 0; tid < kThreads; ++tid) store_fwd(t, out, base, n, tid, kThreads);
  }
}

inline void fk_backward_host(const float* ang, const float* bl, const float* grot,
                             const float* g, float* dang, float* dbl, float* dgrot,
                             float* droot, int B) {
  static BwdTile t;
  for (int base = 0; base < B; base += kTile) {
    const int n = B - base < kTile ? B - base : kTile;
    for (int tid = 0; tid < kThreads; ++tid) load_bwd(t, ang, bl, grot, g, base, n, tid, kThreads);
    for (int it = 0; it < kTrig * kTile; ++it)
      if (it % kTile < n) trig_item(t, it);
    for (int job = 0; job < kChains; ++job)
      for (int pose = 0; pose < n; ++pose) bwd_chain_item(t, job, pose);
    for (int job = 0; job <= kChains; ++job)
      for (int pose = 0; pose < n; ++pose) bwd_reverse_item(t, job, pose);
    for (int tid = 0; tid < kThreads; ++tid)
      store_bwd(t, dang, dbl, dgrot, droot, base, n, tid, kThreads);
  }
}

#endif  // __CUDACC__

}  // namespace dhfk
