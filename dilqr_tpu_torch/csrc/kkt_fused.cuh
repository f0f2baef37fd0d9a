// Per-example math of the module-KKT VJP kernel (kkt_fused.cu), written for
// a team of L lanes.
//
// kkt_example<NU, L>(args, layout, b, team memory, team) runs, for example
// b, the three passes of the JAX kernel `_kkt_kernel`
// (dilqr_tpu/ops/pallas/kkt_fused.py:173) and the rank-1 assembly its
// wrapper leaves to XLA (kkt_fused.py:561-572):
//   1. reverse Riccati of the auxiliary LQR on (C, -r, F) with the
//      zero-mask gains of the frozen active set uz (`_ric_step` :110);
//   2. the alpha=1 rollout of that LQR from dx_0 = 0, giving dtau
//      (`_roll_step` :157);
//   3. the joint reverse recursion of lam and dlam (`_adj_step` :164),
//      with dF_t = -(dlam_{t+1} tau_t^T + lam_{t+1} dtau_t^T),
//      df_t = -dlam_{t+1} and, in full mode, dC_t = -1/2 (dtau_t tau_t^T +
//      tau_t dtau_t^T), dc_t = -dtau_t, dx_init = -dlam_0, stored once.
//
// Lane i of the team owns row i of V, F, VF and Q, column i of K and entry
// i of dtau, lam and dlam (L >= n = nx + nu; n_state is a runtime value).
// Each step is a few phases; a phase is a function of (lane, what the lane
// keeps, the team's shared memory), and a team barrier ends it. A phase
// reads only what earlier phases wrote, so the host build runs lanes
// 0..L-1 of each phase in turn and computes what the card computes
// (tests/test_torch_csrc.py). Each example's arithmetic order depends on L
// alone, not on how many teams a block holds.
//
// Inputs. The cotangent-invariant operands are one slab per step and
// example, [T, B, S] (ops/cuda/kkt_fused.py prepare): C's packed upper
// triangle (row-major (i, j >= i), which symmetrizes C as the JAX kernel's
// load does), F [nx][n] (zero at t = T-1), the mask uz [nu] (1 = frozen),
// the adjoint offset lb = C[:nx, :] tau + c[:nx], tau [n], padded to a
// multiple of 4 floats. The team stages each step's slab into a ring of
// kKktStages slots in its shared memory, two steps ahead of its use, with
// 16-byte cp.async copies. The cotangent g_x [T, B, nx], g_u [T, B, nu] is
// read where it lies, one step ahead, through its T and B strides.
// K, k and dtau live in the team's shared memory, or, where the horizon
// makes that too large, in a global store [T, B, KS], in the same order.
#pragma once

#include <stddef.h>
#include <string.h>

#include "ilqr_fused.cuh"  // DILQR_HD, inv_small

namespace dilqr {

constexpr int kKktStages = 3;  // slab ring slots: the step in use and two ahead

struct KktArgs {
  int T, B;
  const float* slab;       // [T, B, S]
  const float* gx;         // g_x [T, B, nx], unit last stride
  long long gxt, gxb;
  const float* gu;         // g_u [T, B, nu], unit last stride
  long long gut, gub;
  float* dF;               // [T-1, B, nx, n]
  float* df;               // [T-1, B, nx]
  float* dxi;              // [B, nx]; null in "Ff" mode, as dC and dc
  float* dC;               // [T, B, n, n]
  float* dc;               // [T, B, n]
  float* store;            // [T, B, KS] when K, k, dtau do not stay in shared memory
};

// Offsets, in floats, of the slab's parts and of a team's shared memory.
struct KktLayout {
  int nx, n, tri;
  int oF, nF, oU, oL, oT, S;  // slab: C | F | uz | lb | tau, each run 16-byte aligned
  int KS;                 // store a step: K [nu][nx] | k [nu] | dtau [L], zero past n
  int oVF, oQu, oqu, ov, oK, oQK, odx, odt, olam, odlam, oZ, ostore;
  int team;               // floats a team; 4 x an odd number (see kkt_layout)
};

// `store_in_smem`: K, k and dtau of all T steps in the team's memory.
template <int NU, int L>
DILQR_HD KktLayout kkt_layout(int nx, int T, bool store_in_smem) {
  KktLayout y;
  y.nx = nx;
  y.n = nx + NU;
  y.tri = y.n * (y.n + 1) / 2;
  y.oF = (y.tri + 3) / 4 * 4;
  y.nF = (y.n + 3) / 4 * 4;  // F's rows padded with zeros, 16-byte aligned
  y.oU = y.oF + nx * y.nF;
  y.oL = y.oU + NU;
  y.oT = y.oL + nx;
  y.S = (y.oT + y.n + 3) / 4 * 4;
  y.KS = NU * nx + NU + L;
  int o = kKktStages * y.S;
  y.oVF = o;  o += L * (L + 4);
  y.oQu = o;  o += NU * L;
  y.oqu = o;  o += 4;
  y.ov = o;   o += L;
  y.oK = o;   o += NU * L;
  y.oQK = o;  o += NU * L;
  y.odx = o;  o += L;
  y.odt = o;  o += L;
  y.olam = o; o += 2 * L;
  y.odlam = o; o += 2 * L;
  y.oZ = o;   o += L;
  y.ostore = o;
  if (store_in_smem) o += T * y.KS;
  // a multiple of 4 keeps every team's ring 16-byte aligned; 4 x odd puts
  // the up to 8 teams of a warp on 8 different banks for the same offset
  o = (o + 3) / 4;
  if (o % 2 == 0) ++o;
  y.team = 4 * o;
  return y;
}

// four consecutive floats at a 16-byte aligned address: one 128-bit access
DILQR_HD void ld4(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
#else
  for (int i = 0; i < 4; ++i) v[i] = p[i];
#endif
}

DILQR_HD void st4(float* p, const float* v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
#else
  for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
}

// 1/x correctly rounded. A division's IEEE sequence took about 450 of a
// Riccati step's 2,300 cycles on the card; a reciprocal and a product
// round twice, within an ulp or two of the quotient.
DILQR_HD float rcp(float x) {
#ifdef __CUDA_ARCH__
  return __frcp_rn(x);
#else
  return 1.0f / x;
#endif
}

// packed index of C(i, j) in the row-major upper triangle of an n x n matrix
DILQR_HD int tri_index(int i, int j, int n) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo * n - lo * (lo - 1) / 2 + (hi - lo);
}

// What one lane keeps from phase to phase (registers on the card).
template <int NU, int L>
struct KktLane {
  float V[L];     // row `lane` of V (entries < nx)
  float Q[L];     // row `lane` of Q, columns < nx
  float Qxu[NU];  // row `lane` of Q, columns nx + c
  float q, r, r_next;
  float K[NU];    // column `lane` of K
  float k[NU], qu[NU], Quuk[NU];  // the same on every lane
};

// The team on the card: this thread is lane `lane`; a phase ends with a
// barrier. The barrier is the whole warp's: every team of a warp runs the
// same phases in the same order (T, n_state and n_ctrl are the launch's),
// a team past the batch's end has exited, and a constant full mask is one
// instruction where a per-team mask costs a match-and-reduce sequence.
// `Lane` is what a lane keeps from phase to phase. The reverse Riccati
// kernel (riccati_fused.cuh) runs its phases on the same teams.
template <class Lane, int L>
struct DeviceTeam {
  int lane;
  Lane R;

  template <class Fn>
  DILQR_HD void phase(Fn&& f) {
    f(lane, R);
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }

  // start copying n4 16-byte chunks src -> dst (shared); one commit group
  DILQR_HD void stage(float* dst, const float* src, int n4) {
#ifdef __CUDA_ARCH__
    for (int q = lane; q < n4; q += L) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 4 * q);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + 4 * q)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#else
    (void)dst, (void)src, (void)n4;
#endif
  }

  DILQR_HD void commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
  }

  // wait for all but the newest kKktStages - 1 copy groups, then a barrier
  // so that every lane's copies are visible to the team
  DILQR_HD void wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kKktStages - 1) : "memory");
    __syncwarp();
#endif
  }
};

// The team on the host: lanes 0..L-1 of a phase run in turn.
template <class Lane, int L>
struct HostTeam {
  Lane R[L];

  template <class Fn>
  void phase(Fn&& f) {
    for (int l = 0; l < L; ++l) f(l, R[l]);
  }
  void stage(float* dst, const float* src, int n4) {
    memcpy(dst, src, sizeof(float) * 4 * (size_t)n4);
  }
  void commit() {}
  void wait() {}
};

template <int NU, int L, class Team>
DILQR_HD void kkt_example(const KktArgs& a, const KktLayout& y, int b, float* ts, Team& team) {
  using Lane = KktLane<NU, L>;
  const int T = a.T, nx = y.nx, n = y.n;
  const size_t B = (size_t)a.B;
  constexpr int VS = L + 4;  // VF's row stride: 16-byte rows on distinct banks
  float* VF = ts + y.oVF;    // [L][VS], row m = lane m's V F row
  float* Qu = ts + y.oQu;    // [NU][L], the control rows of Q
  float* qu_s = ts + y.oqu;  // [NU]
  float* v_s = ts + y.ov;    // [L]
  float* K_s = ts + y.oK;    // [NU][L]
  float* QK_s = ts + y.oQK;  // [NU][L], Quu K
  float* dx_s = ts + y.odx;  // [L]
  float* dt_s = ts + y.odt;  // [L]
  float* lam_s = ts + y.olam;    // [2][L], lam_t in buffer t & 1
  float* dlam_s = ts + y.odlam;  // [2][L]
  const float* Z = ts + y.oZ;    // [L] zeros: row m >= nx of F
  float* st0 = a.store ? a.store + (size_t)b * y.KS : ts + y.ostore;
  const size_t st_step = a.store ? B * y.KS : (size_t)y.KS;
  const float* slab0 = a.slab + (size_t)b * y.S;
  const int n4 = y.S / 4;
  auto slot = [&](int k) { return ts + (k % kKktStages) * y.S; };
  auto cot = [&](int t, int r) {  // r < n; the address selected, one load
    return *(r < nx ? a.gx + t * a.gxt + (long long)b * a.gxb + r
                    : a.gu + t * a.gut + (long long)b * a.gub + (r - nx));
  };
  // steps visited in order step(0), step(1), ...: stage two ahead
  auto prologue = [&](auto step) {
    for (int k = 0; k < kKktStages - 1; ++k) {
      if (k < T) team.stage(slot(k), slab0 + step(k) * B * y.S, n4);
      else team.commit();
    }
  };
  auto advance = [&](auto step, int k) {
    const int ahead = k + kKktStages - 1;
    if (ahead < T) team.stage(slot(ahead), slab0 + step(ahead) * B * y.S, n4);
    else team.commit();
    team.wait();
  };

  // ---- pass 1: reverse Riccati on (C, -r, F), zero-mask gains ----
  auto rev = [T](int k) { return (size_t)(T - 1 - k); };
  // The team's memory starts zeroed, and what is zero stays so: entries m
  // >= nx of V, v, lam and dlam, K's columns and dtau's entries past n.
  // Inner loops then run to L without a bound check, reading a zero row in
  // place of F's rows past nx; a column past n of VF or Q is computed from
  // finite slab data and never read.
  team.phase([&](int l, Lane&) {
    for (int i = l; i < y.team; i += L) ts[i] = 0.0f;
  });
  prologue(rev);
  team.phase([&](int l, Lane& R) {
#pragma unroll
    for (int j = 0; j < L; ++j) R.V[j] = 0.0f;
    R.r_next = l < n ? cot(T - 1, l) : 0.0f;
  });
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    advance(rev, k);
    const float* s = slot(k);
    const float* C = s;
    const float* F = s + y.oF;
    // VF = V F, row l (zero past nx)
    team.phase([&](int l, Lane& R) {
      R.r = R.r_next;
      if (t > 0 && l < n) R.r_next = cot(t - 1, l);
      float acc[L], f[L];
#pragma unroll
      for (int j = 0; j < L; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int m = 0; m < L; ++m) {
        const float* Fm = m < nx ? F + m * y.nF : Z;
#pragma unroll
        for (int q = 0; q < L; q += 4) ld4(Fm + q, f + q);
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] += R.V[m] * f[j];
      }
#pragma unroll
      for (int q = 0; q < L; q += 4) st4(VF + l * VS + q, acc + q);
    });
    // Q = C + F^T (V F) and q = -r + F^T v, row l; the control rows to
    // shared memory
    team.phase([&](int l, Lane& R) {
      if (l < n) {
        float Fc[L], w[L];  // column l of F, zero past nx; a row of VF, or v
#pragma unroll
        for (int m = 0; m < L; ++m) Fc[m] = (m < nx ? F + m * y.nF : Z)[l];
#pragma unroll
        for (int q = 0; q < L; q += 4) ld4(v_s + q, w + q);
        float qs = 0.0f;
#pragma unroll
        for (int m = 0; m < L; ++m) qs += Fc[m] * w[m];
        R.q = -R.r + qs;
        float acc[L];
#pragma unroll
        for (int j = 0; j < L; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int m = 0; m < L; ++m) {
#pragma unroll
          for (int q = 0; q < L; q += 4) ld4(VF + m * VS + q, w + q);
#pragma unroll
          for (int j = 0; j < L; ++j) acc[j] += Fc[m] * w[j];
        }
#pragma unroll
        for (int j = 0; j < L; ++j) R.Q[j] = C[tri_index(l, j, n)] + acc[j];
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          float a1 = 0.0f;
#pragma unroll
          for (int m = 0; m < L; ++m) a1 += Fc[m] * VF[m * VS + nx + c];
          R.Qxu[c] = C[tri_index(l, nx + c, n)] + a1;
        }
        if (l >= nx) {
          float* row = Qu + (l - nx) * L;
#pragma unroll
          for (int j = 0; j < L; ++j) row[j] = R.Q[j];
#pragma unroll
          for (int c = 0; c < NU; ++c) row[nx + c] = R.Qxu[c];
          qu_s[l - nx] = R.q;
        }
      }
    });
    // gains with the frozen controls masked out and a 1e-8 ridge on their
    // diagonal; for NU == 1, k divides by the UNmasked Quu (the
    // reference's quirk, kkt_fused.py:135-139). k on every lane, K[:, l]
    // on lane l.
    float* st = st0 + t * st_step;
    team.phase([&](int l, Lane& R) {
      float uz[NU], notI[NU], Quu[NU][NU], Qm[NU][NU];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        uz[c] = s[y.oU + c];
        notI[c] = 1.0f - uz[c];
        R.qu[c] = qu_s[c];
      }
#pragma unroll
      for (int c = 0; c < NU; ++c)
#pragma unroll
        for (int d = 0; d < NU; ++d) {
          Quu[c][d] = Qu[c * L + nx + d];
          Qm[c][d] = Quu[c][d] * notI[c] * notI[d] + (c == d ? 1e-8f * uz[c] : 0.0f);
        }
      // every lane computes a column (past nx from finite data, not kept)
      if constexpr (NU == 1) {
        R.k[0] = -(R.qu[0] * notI[0]) * rcp(Quu[0][0]);
        R.K[0] = -(Qu[l] * notI[0]) * rcp(Qm[0][0]);
      } else {
        float Hi[NU][NU];
        inv_small<NU>(Qm, Hi);
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          float sk = 0.0f, sK = 0.0f;
#pragma unroll
          for (int d = 0; d < NU; ++d) {
            sk += Hi[c][d] * (R.qu[d] * notI[d]);
            sK += Hi[c][d] * (Qu[d * L + l] * notI[d]);
          }
          R.k[c] = -sk;
          R.K[c] = -sK;
        }
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float s1 = 0.0f;
#pragma unroll
        for (int d = 0; d < NU; ++d) s1 += Quu[c][d] * R.k[d];
        R.Quuk[c] = s1;
      }
      if (l < nx) {
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          float s1 = 0.0f;
#pragma unroll
          for (int d = 0; d < NU; ++d) s1 += Quu[c][d] * R.K[d];
          K_s[c * L + l] = R.K[c];
          QK_s[c * L + l] = s1;
          st[c * nx + l] = R.K[c];
        }
      }
      if (l == 0) {
#pragma unroll
        for (int c = 0; c < NU; ++c) st[NU * nx + c] = R.k[c];
      }
    });
    // V' = Qxx + Qxu K + K^T Qux + K^T (Quu K), row l
    // v' = qx + Qxu k + K^T qu + K^T (Quu k)          (unmasked Q, as JAX)
    team.phase([&](int l, Lane& R) {
      if (l < nx) {
        float a1[L] = {}, a2[L] = {}, a3[L] = {}, w[L];
#pragma unroll
        for (int c = 0; c < NU; ++c) {
#pragma unroll
          for (int q = 0; q < L; q += 4) ld4(K_s + c * L + q, w + q);
#pragma unroll
          for (int j = 0; j < L; ++j) a1[j] += R.Qxu[c] * w[j];
#pragma unroll
          for (int q = 0; q < L; q += 4) ld4(Qu + c * L + q, w + q);
#pragma unroll
          for (int j = 0; j < L; ++j) a2[j] += R.K[c] * w[j];
#pragma unroll
          for (int q = 0; q < L; q += 4) ld4(QK_s + c * L + q, w + q);
#pragma unroll
          for (int j = 0; j < L; ++j) a3[j] += R.K[c] * w[j];
        }
#pragma unroll
        for (int j = 0; j < L; ++j) R.V[j] = j < nx ? ((R.Q[j] + a1[j]) + a2[j]) + a3[j] : 0.0f;
        float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c) {
          s1 += R.Qxu[c] * R.k[c];
          s2 += R.K[c] * R.qu[c];
          s3 += R.K[c] * R.Quuk[c];
        }
        v_s[l] = ((R.q + s1) + s2) + s3;
      }
    });
  }

  // ---- pass 2: rollout of the auxiliary LQR, dx_0 = 0, alpha = 1 ----
  auto fwd = [](int k) { return (size_t)k; };
  prologue(fwd);
  team.phase([&](int l, Lane&) { dx_s[l] = 0.0f; });
  for (int t = 0; t < T; ++t) {
    advance(fwd, t);
    const float* s = slot(t);
    float* st = st0 + t * st_step;
    // du = (K dx + k) * (1 - uz) on every lane; dtau_t = (dx, du)
    team.phase([&](int l, Lane&) {
      float du[NU];
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (j < nx) acc += st[c * nx + j] * dx_s[j];
        du[c] = (acc + st[NU * nx + c]) * (1.0f - s[y.oU + c]);
      }
      float d = l < nx ? dx_s[l] : 0.0f;
#pragma unroll
      for (int c = 0; c < NU; ++c)
        if (l == nx + c) d = du[c];
      dt_s[l] = d;
      st[NU * nx + NU + l] = d;  // zero past n
    });
    // dx_{t+1} = F_t dtau_t, row l
    team.phase([&](int l, Lane&) {
      if (l < nx) {
        float f[L], d[L];
#pragma unroll
        for (int q = 0; q < L; q += 4) {
          ld4(s + y.oF + l * y.nF + q, f + q);
          ld4(dt_s + q, d + q);
        }
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < L; ++j) acc += f[j] * d[j];  // dt_s zero past n
        dx_s[l] = acc;
      }
    });
  }

  // ---- pass 3: joint reverse adjoints and the assembly ----
  // lam_t  = lb_t + F_x^T lam_{t+1}
  // dlam_t = C[:nx, :] dtau_t - r_t[:nx] + F_x^T dlam_{t+1}
  prologue(rev);
  team.phase([&](int l, Lane& R) { R.r_next = l < nx ? cot(T - 1, l) : 0.0f; });
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    advance(rev, k);
    const float* s = slot(k);
    const float* dt = st0 + t * st_step + NU * nx + NU;
    team.phase([&](int l, Lane& R) {
      R.r = R.r_next;
      if (t > 0 && l < nx) R.r_next = cot(t - 1, l);
      const float* tau = s + y.oT;
      const float* lam1 = lam_s + ((t + 1) & 1) * L;   // lam_{t+1}
      const float* dlam1 = dlam_s + ((t + 1) & 1) * L;
      const size_t tb = (size_t)t * B + b;
      // lane l writes column l of dF_t and dC_t: a row's n floats are
      // consecutive lanes' stores
      if (l < n) {
        const float tl = tau[l], dl = dt[l];
        if (t < T - 1) {
          float* dF = a.dF + tb * nx * n + l;
          for (int i = 0; i < nx; ++i) dF[i * n] = -(dlam1[i] * tl + lam1[i] * dl);
        }
        if (a.dC) {
          float* dC = a.dC + tb * n * n + l;
          for (int i = 0; i < n; ++i) dC[i * n] = -0.5f * (dt[i] * tl + tau[i] * dl);
          a.dc[tb * n + l] = -dl;
        }
      }
      if (t < T - 1 && l < nx) a.df[tb * nx + l] = -dlam1[l];
      if (l < nx) {
        const float* C = s;
        const float* F = s + y.oF;
        float fl = 0.0f, fd = 0.0f, cd = 0.0f, w1[L], w2[L];
#pragma unroll
        for (int q = 0; q < L; q += 4) {
          ld4(lam1 + q, w1 + q);
          ld4(dlam1 + q, w2 + q);
        }
#pragma unroll
        for (int m = 0; m < L; ++m) {
          const float f = (m < nx ? F + m * y.nF : Z)[l];
          fl += f * w1[m];
          fd += f * w2[m];
        }
#pragma unroll
        for (int j = 0; j < L; ++j) cd += C[tri_index(l, j, n)] * dt[j];  // dt zero past n
        const float lam = s[y.oL + l] + fl;
        const float dlam = (cd - R.r) + fd;
        lam_s[(t & 1) * L + l] = lam;
        dlam_s[(t & 1) * L + l] = dlam;
        if (t == 0 && a.dxi) a.dxi[(size_t)b * nx + l] = -dlam;
      }
    });
  }
}

// Calls f(NU, L) as integral constants for n_ctrl in 1..3 and the team
// size: the smallest power of two >= max(4, n_state + n_ctrl), at most 32.
// Returns -1 for a shape no instantiation takes.
template <int NU_, int L_>
struct KktShape {
  static constexpr int NU = NU_, L = L_;
};

template <int NU, class Fn>
int kkt_dispatch_l(int n, Fn&& f) {
  if (n <= 4) return f(KktShape<NU, 4>{});
  if (n <= 8) return f(KktShape<NU, 8>{});
  if (n <= 16) return f(KktShape<NU, 16>{});
  if (n <= 32) return f(KktShape<NU, 32>{});
  return -1;
}

template <class Fn>
int kkt_dispatch(int nx, int nu, Fn&& f) {
  if (nx < 1) return -1;
  if (nu == 1) return kkt_dispatch_l<1>(nx + 1, f);
  if (nu == 2) return kkt_dispatch_l<2>(nx + 2, f);
  if (nu == 3) return kkt_dispatch_l<3>(nx + 3, f);
  return -1;
}

}  // namespace dilqr
