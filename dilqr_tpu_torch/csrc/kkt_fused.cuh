// Per-example math of the module-KKT VJP kernel (kkt_fused.cu).
//
// kkt_example<NX, NU>(args, b) runs the three passes of the JAX kernel
// `_kkt_kernel` (dilqr_tpu/ops/pallas/kkt_fused.py:173) for example b:
//   1. reverse Riccati of the auxiliary LQR on (C, -r, F) with the
//      zero-mask gains of the frozen active set uz (`_ric_step` :110);
//   2. the alpha=1 rollout of that LQR from dx_0 = 0, giving dtau
//      (`_roll_step` :157);
//   3. the joint reverse recursion of lam and dlam (`_adj_step` :164).
// Every per-step array is laid out [T, k, B] (k the small index, b the
// fastest), so the 32 threads of a warp, one example each, read and write
// 32 consecutive floats. C comes as its packed upper triangle, row-major
// (i, j >= i), which symmetrizes it exactly as the JAX kernel's load does.
//
// The functions are __host__ __device__: a host compiler builds the same
// code for the CPU tests (tests/test_torch_csrc.py).
#pragma once

#include <stddef.h>

#include "ilqr_fused.cuh"  // DILQR_HD, inv_small

// The instantiated (NX, NU) shapes: pendulum, the JAX kernel tests' nx=4,
// cartpole, rocket. ops/cuda/kkt_fused.py SHAPES lists the same pairs.
#define DILQR_KKT_SHAPES(X) X(3, 1) X(4, 1) X(5, 1) X(4, 2) X(4, 3) X(13, 3)

namespace dilqr {

struct KktArgs {
  int T, B;
  const float* C;   // [T, N(N+1)/2, B] packed upper triangle
  const float* F;   // [T, NX*N, B] row-major [NX][N]; the t = T-1 slab is zero
  const float* r;   // [T, N, B] cotangent (g_x, g_u)
  const float* uz;  // [T, NU, B] 1 = control frozen at the bound, else 0
  const float* lb;  // [T, NX, B] adjoint offset C[:NX, :] tau + c[:NX]
  float* dtau;      // [T, N, B] out
  float* lam;       // [T, NX, B] out
  float* dlam;      // [T, NX, B] out
  float* K;         // [T, NU*NX, B] scratch: feedback gains
  float* k;         // [T, NU, B] scratch: feedforward gains
};

template <int NX, int NU>
DILQR_HD void kkt_example(const KktArgs& a, int b) {
  constexpr int N = NX + NU;
  constexpr int TRI = N * (N + 1) / 2;
  const int T = a.T;
  const size_t B = (size_t)a.B;
  // element (t, i) of a [T, k, B] array
  auto at = [&](int t, int i, int kdim) { return ((size_t)t * kdim + i) * B + b; };

  // ---- pass 1: reverse Riccati on (C, -r, F), zero-mask gains ----
  float V[NX][NX], v[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    v[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) V[i][j] = 0.0f;
  }
  for (int t = T - 1; t >= 0; --t) {
    float F[NX][N];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) F[i][j] = a.F[at(t, i * N + j, NX * N)];

    // VF = V F
    float VF[NX][N];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int m = 0; m < NX; ++m) s += V[i][m] * F[m][j];
        VF[i][j] = s;
      }
    // Q = C + F^T (V F), upper triangle mirrored; q = -r + F^T v
    float Q[N][N], q[N];
    {
      int p = 0;
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = i; j < N; ++j, ++p) {
          float s = 0.0f;
#pragma unroll
          for (int m = 0; m < NX; ++m) s += F[m][i] * VF[m][j];
          Q[i][j] = a.C[at(t, p, TRI)] + s;
          Q[j][i] = Q[i][j];
        }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) s += F[m][i] * v[m];
      q[i] = -a.r[at(t, i, N)] + s;
    }

    // gains with the frozen controls masked out and a 1e-8 ridge on their
    // diagonal; for NU == 1, k divides by the UNmasked Quu (the
    // reference's quirk, kkt_fused.py:135-139)
    float uz[NU], notI[NU];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      uz[c] = a.uz[at(t, c, NU)];
      notI[c] = 1.0f - uz[c];
    }
    float Qm[NU][NU];
#pragma unroll
    for (int c = 0; c < NU; ++c)
#pragma unroll
      for (int d = 0; d < NU; ++d)
        Qm[c][d] = Q[NX + c][NX + d] * notI[c] * notI[d] + (c == d ? 1e-8f * uz[c] : 0.0f);
    float K[NU][NX], kt[NU];
    if constexpr (NU == 1) {
      kt[0] = -(q[NX] * notI[0]) / Q[NX][NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) K[0][j] = -(Q[NX][j] * notI[0]) / Qm[0][0];
    } else {
      float Hi[NU][NU];
      inv_small<NU>(Qm, Hi);
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < NU; ++d) s += Hi[c][d] * (q[NX + d] * notI[d]);
        kt[c] = -s;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          float sj = 0.0f;
#pragma unroll
          for (int d = 0; d < NU; ++d) sj += Hi[c][d] * (Q[NX + d][j] * notI[d]);
          K[c][j] = -sj;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      a.k[at(t, c, NU)] = kt[c];
#pragma unroll
      for (int j = 0; j < NX; ++j) a.K[at(t, c * NX + j, NU * NX)] = K[c][j];
    }

    // V' = Qxx + Qxu K + K^T Qux + K^T (Quu K)   (last term symmetric)
    // v' = qx + Qxu k + K^T qu + K^T (Quu k)      (unmasked Q, as JAX)
    float QuuK[NU][NX], Quuk[NU];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < NU; ++d) s += Q[NX + c][NX + d] * kt[d];
      Quuk[c] = s;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float sj = 0.0f;
#pragma unroll
        for (int d = 0; d < NU; ++d) sj += Q[NX + c][NX + d] * K[d][j];
        QuuK[c][j] = sj;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = i; j < NX; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c) s += K[c][i] * QuuK[c][j];
        float qk = 0.0f, kq = 0.0f, qk2 = 0.0f, kq2 = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          qk += Q[i][NX + c] * K[c][j];
          kq += K[c][i] * Q[NX + c][j];
          qk2 += Q[j][NX + c] * K[c][i];
          kq2 += K[c][j] * Q[NX + c][i];
        }
        V[i][j] = Q[i][j] + qk + kq + s;
        V[j][i] = Q[j][i] + qk2 + kq2 + s;
      }
      float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        s1 += Q[i][NX + c] * kt[c];
        s2 += K[c][i] * q[NX + c];
        s3 += K[c][i] * Quuk[c];
      }
      v[i] = q[i] + s1 + s2 + s3;
    }
  }

  // ---- pass 2: rollout of the auxiliary LQR, dx_0 = 0, alpha = 1 ----
  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = 0.0f;
  for (int t = 0; t < T; ++t) {
    float dt[N];
#pragma unroll
    for (int i = 0; i < NX; ++i) dt[i] = dx[i];
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) s += a.K[at(t, c * NX + j, NU * NX)] * dx[j];
      dt[NX + c] = (s + a.k[at(t, c, NU)]) * (1.0f - a.uz[at(t, c, NU)]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) a.dtau[at(t, i, N)] = dt[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) s += a.F[at(t, i * N + j, NX * N)] * dt[j];
      dx[i] = s;
    }
  }

  // ---- pass 3: joint reverse adjoints ----
  // lam_t  = lb_t + F_x^T lam_{t+1}
  // dlam_t = C[:NX, :] dtau_t - r_t[:NX] + F_x^T dlam_{t+1}
  float lam[NX], dlam[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) lam[i] = dlam[i] = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    float dt[N];
#pragma unroll
    for (int j = 0; j < N; ++j) dt[j] = a.dtau[at(t, j, N)];
    float nl[NX], nd[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float fl = 0.0f, fd = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        const float f = a.F[at(t, m * N + i, NX * N)];
        fl += f * lam[m];
        fd += f * dlam[m];
      }
      float cd = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        // packed index of (min(i, j), max(i, j))
        const int lo = i < j ? i : j, hi = i < j ? j : i;
        const int p = lo * N - lo * (lo - 1) / 2 + (hi - lo);
        cd += a.C[at(t, p, TRI)] * dt[j];
      }
      nl[i] = a.lb[at(t, i, NX)] + fl;
      nd[i] = cd - a.r[at(t, i, N)] + fd;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      lam[i] = nl[i];
      dlam[i] = nd[i];
      a.lam[at(t, i, NX)] = nl[i];
      a.dlam[at(t, i, NX)] = nd[i];
    }
  }
}

}  // namespace dilqr
