// Per-example math of the reverse Riccati kernel (riccati_fused.cu).
//
// riccati_example<NX, MODE>(args, b) runs, for example b, the T-step
// reverse recursion of the JAX kernel `_riccati_kernel`
// (dilqr_tpu/ops/pallas/riccati_fused.py:57-158) for one control:
//   Q_t = C_t + F_t^T V_{t+1} F_t,  q_t = c_t + F_t^T v_{t+1},
// the gains in one of three modes, and the cost-to-go update. What it keeps
// of the TPU kernel:
//   * Q is formed from C's UPPER triangle and mirrored (:94-102), so the
//     result equals the plain recursion's for symmetric C only -- which is
//     what every cost path produces (QuadCost is documented symmetric, a
//     quadraticized callable cost is a Hessian);
//   * at t = T-1, Q = C and q = c exactly (V_T = 0; the JAX kernel's zero
//     F slab, :188-192), and F is not read there;
//   * box mode: k = clamp(-qu/Quu, lb, ub), the active set is a bound with
//     the gradient pointing outward, H_free = Quu If + 1e-11 (:116-128);
//   * zero mode: K divides by Quu (1 - I) + 1e-8 I, k by the UNMASKED Quu
//     (:129-137);
//   * V is symmetric: only its upper triangle is formed and kept.
// Every step keeps V, v, F, Q's triangle and one column of V F in
// registers; Q is built column by column so that only NX values of V F are
// live at a time.
//
// The functions are __host__ __device__: a host compiler builds the same
// code for the CPU tests (tests/test_torch_csrc.py).
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define DILQR_HD __host__ __device__ __forceinline__
#else
#define DILQR_HD inline
#endif

namespace dilqr {

// gain modes; ops/cuda/riccati_fused.py MODES lists the same ids
enum RiccatiMode { kModeFree = 0, kModeBox = 1, kModeZero = 2 };

// the instantiated state sizes; riccati_fused.py MAX_NX is the largest
#define DILQR_RICCATI_NX(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

struct RiccatiArgs {
  int T, B;
  // element (t, b, i, j) of C at t * sCt + b * sCb + i * N + j, likewise c
  // (t, b, i) and F (t, b, i, j) for t < T-1; any T and B strides (an
  // expanded, example-invariant C has sCt = sCb = 0)
  const float* C;
  long long sCt, sCb;
  const float* c;
  long long sct, scb;
  const float* F;
  long long sFt, sFb;
  const float* lb;  // [T, B] box: lower - u (delta_u folded in); zero: the mask
  const float* ub;  // [T, B] box: upper - u; otherwise unread
  float* K;         // [T, B, NX] out
  float* k;         // [T, B] out
};

// index of (i, j), i <= j, in a row-major upper triangle of side M
DILQR_HD constexpr int tri_at(int M, int i, int j) { return i * M - i * (i - 1) / 2 + (j - i); }
// the same for any (i, j) of a symmetric matrix kept as its upper triangle
DILQR_HD constexpr int sym_at(int M, int i, int j) {
  return i <= j ? tri_at(M, i, j) : tri_at(M, j, i);
}

template <int NX, int MODE>
DILQR_HD void riccati_example(const RiccatiArgs& a, int b) {
  constexpr int N = NX + 1;
  constexpr int TRI = N * (N + 1) / 2;
  float V[NX * (NX + 1) / 2], v[NX];
#pragma unroll
  for (int i = 0; i < NX * (NX + 1) / 2; ++i) V[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) v[i] = 0.0f;

  for (int t = a.T - 1; t >= 0; --t) {
    const float* Ct = a.C + t * a.sCt + b * a.sCb;
    const float* ct = a.c + t * a.sct + b * a.scb;
    float Q[TRI], q[N];
    if (t == a.T - 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        q[i] = ct[i];
#pragma unroll
        for (int j = i; j < N; ++j) Q[tri_at(N, i, j)] = Ct[i * N + j];
      }
    } else {
      const float* Ft = a.F + t * a.sFt + b * a.sFb;
      float F[NX][N];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) F[i][j] = Ft[i * N + j];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        // column j of V F, summed in the JAX kernel's order
        float tmp[NX];
#pragma unroll
        for (int r = 0; r < NX; ++r) {
          float s = V[sym_at(NX, r, 0)] * F[0][j];
#pragma unroll
          for (int m = 1; m < NX; ++m) s += V[sym_at(NX, r, m)] * F[m][j];
          tmp[r] = s;
        }
#pragma unroll
        for (int i = 0; i <= j; ++i) {
          float s = Ct[i * N + j];
#pragma unroll
          for (int r = 0; r < NX; ++r) s += F[r][i] * tmp[r];
          Q[tri_at(N, i, j)] = s;
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float s = ct[i];
#pragma unroll
        for (int r = 0; r < NX; ++r) s += F[r][i] * v[r];
        q[i] = s;
      }
    }

    // gains for the one control
    const float Quu = Q[tri_at(N, NX, NX)], qu = q[NX];
    const size_t tb = (size_t)t * a.B + b;
    float K[NX], kt;
    if constexpr (MODE == kModeBox) {
      const float lo = a.lb[tb], hi = a.ub[tb];
      const float kf = -qu / Quu;
      kt = kf < lo ? lo : kf;  // clamp; NaN passes through as in jnp.clip
      kt = kt > hi ? hi : kt;
      const float g = Quu * kt + qu;
      const bool active = (kt <= lo && g > 0.0f) || (kt >= hi && g < 0.0f);
      const float If = active ? 0.0f : 1.0f;
      const float Hf = Quu * If + 1e-11f;
#pragma unroll
      for (int j = 0; j < NX; ++j) K[j] = -(Q[tri_at(N, j, NX)] * If) / Hf;
    } else if constexpr (MODE == kModeZero) {
      const float uz = a.lb[tb];
      const float notI = 1.0f - uz;
      const float Qm = Quu * notI + 1e-8f * uz;
      kt = -(qu * notI) / Quu;
#pragma unroll
      for (int j = 0; j < NX; ++j) K[j] = -(Q[tri_at(N, j, NX)] * notI) / Qm;
    } else {
      kt = -qu / Quu;
#pragma unroll
      for (int j = 0; j < NX; ++j) K[j] = -Q[tri_at(N, j, NX)] / Quu;
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) a.K[tb * NX + j] = K[j];
    a.k[tb] = kt;

    // V' = Qxx + Qxu K^T + K Qux + Quu K K^T, v' = qx + Qxu k + K (qu + Quu k)
    const float qu_plus = qu + Quu * kt;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const float Qi = Q[tri_at(N, i, NX)];
#pragma unroll
      for (int j = i; j < NX; ++j)
        V[tri_at(NX, i, j)] = Q[tri_at(N, i, j)] + Qi * K[j] + K[i] * Q[tri_at(N, j, NX)]
                              + Quu * K[i] * K[j];
      v[i] = q[i] + Qi * kt + K[i] * qu_plus;
    }
  }
}

}  // namespace dilqr
