// Per-pose math of the DH forward kinematics and its hand-derived reverse
// walk.  Shared by the CUDA kernels (fk_kernels.cu) and by a host build in
// the CPU tests (compiled with g++ and __host__/__device__ defined empty), so
// the kernels' arithmetic is checked before the card ever runs it.
//
// One call handles one pose.  Conventions are those of dhaug_torch/ops/fk.py:
// 33 angles in degrees packed [right_leg(5), left_leg(5), body(13),
// right_hand(5), left_hand(5)], 15 bone lengths in FK order, XYZ Euler global
// rotation in degrees, root in metres; the output is the 16-joint pose.
//
// Chain recurrence:   p_i = p_{i-1} + R_{i-1} t_i,   R_i = R_{i-1} Q_i
// Reverse walk (dp flows down unchanged, external cotangents are added at the
// link whose endpoint they belong to):
//   dt_i = R_{i-1}^T dp,  dQ_i = R_{i-1}^T dR,  dR <- dR Q_i^T + dp (x) t_i
// The arm chains start from body link 8's cumulative (R, p); their start
// cotangents are injected into body link 8.
#pragma once

#include <math.h>

namespace dhfk {

constexpr float kDeg = 0.017453292519943295f;  // pi / 180
// cos(+-90 deg) as float32, as the reference computes it (cos in double,
// rounded to float): tiny, not zero.
constexpr float kCos90 = 6.123234e-17f;

// One kinematic chain of L links, all compile-time constants.
template <int L>
struct ChainSpec {
  int angle0;     // index of the chain's first angle in the packed 33
  float ca[L];    // cos(alpha)
  float sa[L];    // sin(alpha)
  float th0[L];   // theta offset, degrees
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
          {0.f, -90.f, 180.f, 0.f, 0.f},
          {5, -1, -1, 3, 1},
          {1.f, 1.f, 1.f, 1.f, 1.f},
          {-1, -1, -1, -1, -1},
          {1, -1, -1, 2, 3}};
}

__host__ __device__ constexpr ChainSpec<5> left_leg() {
  return {5,
          {1.f, kCos90, kCos90, 1.f, 1.f},
          {0.f, 1.f, 1.f, 0.f, 0.f},
          {180.f, -90.f, 0.f, 0.f, 0.f},
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
          {90.f, -90.f, -90.f, -90.f, -90.f, -90.f, -90.f,
           -90.f, -90.f, -90.f, -90.f, 0.f, 0.f},
          {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, 14},
          {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f},
          {-1, -1, -1, 6, -1, -1, 7, -1, -1, -1, -1, -1, -1},
          {0, -1, -1, 7, -1, -1, 8, -1, -1, -1, -1, -1, 9}};
}

__host__ __device__ constexpr ChainSpec<5> right_hand() {
  return {23,
          {kCos90, kCos90, kCos90, 1.f, 1.f},
          {-1.f, -1.f, -1.f, 0.f, 0.f},
          {-180.f, -90.f, 180.f, 0.f, 0.f},
          {9, -1, -1, 11, 13},
          {-1.f, 1.f, 1.f, 1.f, 1.f},  // a0 = -right_shoulder
          {-1, -1, -1, -1, -1},
          {13, -1, -1, 14, 15}};
}

__host__ __device__ constexpr ChainSpec<5> left_hand() {
  return {28,
          {kCos90, kCos90, kCos90, 1.f, 1.f},
          {-1.f, 1.f, 1.f, 0.f, 0.f},
          {0.f, -90.f, 0.f, 0.f, 0.f},
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

// C = A^T B
__host__ __device__ inline void rot_mul_T1(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}

// C = A B^T
__host__ __device__ inline void rot_mul_T2(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2];
}

// One DH link: rotation block Q, translation t, and (ct, st) for the
// angle gradient.
template <int L>
__host__ __device__ inline void link_qt(const ChainSpec<L>& s, int i, const float* ang,
                                        const float* bl, float* Q, float* t,
                                        float& ct, float& st) {
  const float th = (ang[s.angle0 + i] + s.th0[i]) * kDeg;
  ct = cosf(th);
  st = sinf(th);
  const float ca = s.ca[i], sa = s.sa[i];
  Q[0] = ct;       Q[1] = -st;      Q[2] = 0.f;
  Q[3] = st * ca;  Q[4] = ct * ca;  Q[5] = -sa;
  Q[6] = st * sa;  Q[7] = ct * sa;  Q[8] = ca;
  const float a = s.a_bone[i] >= 0 ? s.a_sign[i] * bl[s.a_bone[i]] : 0.f;
  const float d = s.d_bone[i] >= 0 ? bl[s.d_bone[i]] : 0.f;
  t[0] = a;
  t[1] = -sa * d;
  t[2] = ca * d;
}

// Forward walk of one chain.  On entry (R, p) hold the start frame when
// HAS_START, else they are ignored.  emit(slot, p) is called for every link
// endpoint that is an output joint.  When CAPTURE >= 0 the cumulative (R, p)
// after that link are copied to (Rc, pc).
template <int L, bool HAS_START, int CAPTURE, class Emit>
__host__ __device__ inline void walk_forward(const ChainSpec<L>& s, const float* ang,
                                             const float* bl, float* R, float* p,
                                             Emit& emit, float* Rc, float* pc) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float Q[9], t[3], ct, st;
    link_qt(s, i, ang, bl, Q, t, ct, st);
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
    if (s.slot[i] >= 0) emit(s.slot[i], p);
    if (i == CAPTURE) {
#pragma unroll
      for (int k = 0; k < 9; ++k) Rc[k] = R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) pc[k] = p[k];
    }
  }
}

// Global rotation Rx @ Ry @ Rz from XYZ Euler angles in degrees; with
// non-null d{x,y,z} also its partials with respect to each angle (radians).
__host__ __device__ inline void euler_xyz(const float* grot, float* Rg, float* dx,
                                          float* dy, float* dz) {
  const float gx = grot[0] * kDeg, gy = grot[1] * kDeg, gz = grot[2] * kDeg;
  const float cx = cosf(gx), sx = sinf(gx);
  const float cy = cosf(gy), sy = sinf(gy);
  const float cz = cosf(gz), sz = sinf(gz);
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

// out[3 slot ..] = Rg p + root
struct EmitWorld {
  const float* Rg;
  const float* root;
  float* out;
  __host__ __device__ void operator()(int slot, const float* p) const {
    float w[3];
    rot_apply(Rg, p, w);
    out[3 * slot + 0] = w[0] + root[0];
    out[3 * slot + 1] = w[1] + root[1];
    out[3 * slot + 2] = w[2] + root[2];
  }
};

// dRg += g_slot (x) p,  droot += g_slot
struct EmitGlobalGrad {
  const float* g;
  float dRg[9];
  float droot[3];
  __host__ __device__ void operator()(int slot, const float* p) {
    const float* gs = g + 3 * slot;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      droot[r] += gs[r];
#pragma unroll
      for (int c = 0; c < 3; ++c) dRg[3 * r + c] += gs[r] * p[c];
    }
  }
};

// ---------------------------------------------------------------------------
// Forward: one pose -> out[48] (16 joints x 3)
// ---------------------------------------------------------------------------

__host__ __device__ inline void fk_pose_forward(const float* ang, const float* bl,
                                                const float* grot, const float* root,
                                                float* out) {
  float Rg[9];
  euler_xyz(grot, Rg, nullptr, nullptr, nullptr);
  EmitWorld emit{Rg, root, out};
  float R[9], p[3], R8[9], p8[3];

  constexpr ChainSpec<5> rl = right_leg();
  constexpr ChainSpec<5> ll = left_leg();
  constexpr ChainSpec<13> bd = body();
  constexpr ChainSpec<5> rh = right_hand();
  constexpr ChainSpec<5> lh = left_hand();

  walk_forward<5, false, -1>(rl, ang, bl, R, p, emit, nullptr, nullptr);
  walk_forward<5, false, -1>(ll, ang, bl, R, p, emit, nullptr, nullptr);
  walk_forward<13, false, 8>(bd, ang, bl, R, p, emit, R8, p8);
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = R8[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = p8[k];
  walk_forward<5, true, -1>(rh, ang, bl, R, p, emit, nullptr, nullptr);
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = R8[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = p8[k];
  walk_forward<5, true, -1>(lh, ang, bl, R, p, emit, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Reverse walk of one chain.  Recomputes the chain's cumulative rotations
// (only this chain's are live), then walks back from the last link.  Output
// joint cotangents are du = Rg^T g_slot.  When EXT >= 0, (ext_dR, ext_dp) are
// added at link EXT.  Writes the chain's angle gradients and bone gradients;
// when HAS_START adds the start frame's cotangents to (dR_start, dp_start).
template <int L, bool HAS_START, int EXT>
__host__ __device__ inline void reverse_chain(const ChainSpec<L>& s, const float* ang,
                                              const float* bl, const float* Rg,
                                              const float* g, const float* start_R,
                                              const float* ext_dR, const float* ext_dp,
                                              float* dang, float* dbl,
                                              float* dR_start, float* dp_start) {
  float Rc[L][9];  // cumulative rotation after each link, start composed in
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float Q[9], t[3], ct, st;
    link_qt(s, i, ang, bl, Q, t, ct, st);
    if (i == 0) {
      if constexpr (HAS_START) {
        rot_mul(start_R, Q, Rc[0]);
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) Rc[0][k] = Q[k];
      }
    } else {
      rot_mul(Rc[i - 1], Q, Rc[i]);
    }
  }

  float dR[9], dp[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) dR[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) dp[k] = 0.f;

#pragma unroll
  for (int i = L - 1; i >= 0; --i) {
    if (s.slot[i] >= 0) {
      float du[3];
      rot_T_apply(Rg, g + 3 * s.slot[i], du);
      dp[0] += du[0];
      dp[1] += du[1];
      dp[2] += du[2];
    }
    if (i == EXT) {
#pragma unroll
      for (int k = 0; k < 9; ++k) dR[k] += ext_dR[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) dp[k] += ext_dp[k];
    }
    float dt[3], dQ[9];
    if (i > 0) {
      rot_T_apply(Rc[i - 1], dp, dt);
      rot_mul_T1(Rc[i - 1], dR, dQ);
    } else if constexpr (HAS_START) {
      rot_T_apply(start_R, dp, dt);
      rot_mul_T1(start_R, dR, dQ);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) dt[k] = dp[k];
#pragma unroll
      for (int k = 0; k < 9; ++k) dQ[k] = dR[k];
    }

    float Q[9], t[3], ct, st;
    link_qt(s, i, ang, bl, Q, t, ct, st);
    const float ca = s.ca[i], sa = s.sa[i];
    const float drad = -st * dQ[0] - ct * dQ[1] + ca * (ct * dQ[3] - st * dQ[4]) +
                       sa * (ct * dQ[6] - st * dQ[7]);
    dang[s.angle0 + i] = drad * kDeg;
    // t = (a, -sa d, ca d); a = a_sign * bone, d = bone
    if (s.a_bone[i] >= 0) dbl[s.a_bone[i]] = s.a_sign[i] * dt[0];
    if (s.d_bone[i] >= 0) dbl[s.d_bone[i]] = -sa * dt[1] + ca * dt[2];

    float dRQ[9];
    rot_mul_T2(dR, Q, dRQ);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) dR[3 * r + c] = dRQ[3 * r + c] + dp[r] * t[c];
  }
  if constexpr (HAS_START) {
#pragma unroll
    for (int k = 0; k < 9; ++k) dR_start[k] += dR[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) dp_start[k] += dp[k];
  }
}

// One pose's VJP: cotangent g[48] -> dang[33], dbl[15], dgrot[3], droot[3].
__host__ __device__ inline void fk_pose_backward(const float* ang, const float* bl,
                                                 const float* grot, const float* g,
                                                 float* dang, float* dbl, float* dgrot,
                                                 float* droot) {
  constexpr ChainSpec<5> rl = right_leg();
  constexpr ChainSpec<5> ll = left_leg();
  constexpr ChainSpec<13> bd = body();
  constexpr ChainSpec<5> rh = right_hand();
  constexpr ChainSpec<5> lh = left_hand();

  float Rg[9], R8[9];
  // Phase 1: forward walk, global-rotation and root gradients.
  {
    float dRx[9], dRy[9], dRz[9];
    euler_xyz(grot, Rg, dRx, dRy, dRz);
    EmitGlobalGrad acc{g, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    float R[9], p[3], p8[3];
    walk_forward<5, false, -1>(rl, ang, bl, R, p, acc, nullptr, nullptr);
    walk_forward<5, false, -1>(ll, ang, bl, R, p, acc, nullptr, nullptr);
    walk_forward<13, false, 8>(bd, ang, bl, R, p, acc, R8, p8);
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = R8[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = p8[k];
    walk_forward<5, true, -1>(rh, ang, bl, R, p, acc, nullptr, nullptr);
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = R8[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = p8[k];
    walk_forward<5, true, -1>(lh, ang, bl, R, p, acc, nullptr, nullptr);

    float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      cx += acc.dRg[k] * dRx[k];
      cy += acc.dRg[k] * dRy[k];
      cz += acc.dRg[k] * dRz[k];
    }
    dgrot[0] = cx * kDeg;
    dgrot[1] = cy * kDeg;
    dgrot[2] = cz * kDeg;
    droot[0] = acc.droot[0];
    droot[1] = acc.droot[1];
    droot[2] = acc.droot[2];
  }

  // Phase 2: reverse walks, chain by chain; the arms before the body, whose
  // link 8 takes the arms' start cotangents.
  float arm_dR[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float arm_dp[3] = {0.f, 0.f, 0.f};
  reverse_chain<5, false, -1>(rl, ang, bl, Rg, g, nullptr, nullptr, nullptr, dang, dbl,
                              nullptr, nullptr);
  reverse_chain<5, false, -1>(ll, ang, bl, Rg, g, nullptr, nullptr, nullptr, dang, dbl,
                              nullptr, nullptr);
  reverse_chain<5, true, -1>(rh, ang, bl, Rg, g, R8, nullptr, nullptr, dang, dbl, arm_dR,
                             arm_dp);
  reverse_chain<5, true, -1>(lh, ang, bl, Rg, g, R8, nullptr, nullptr, dang, dbl, arm_dR,
                             arm_dp);
  reverse_chain<13, false, 8>(bd, ang, bl, Rg, g, nullptr, arm_dR, arm_dp, dang, dbl,
                              nullptr, nullptr);
}

}  // namespace dhfk
