// Per-example math of the reverse Riccati kernel (riccati_fused.cu), written
// for a team of lanes.
//
// riccati_team<L, MODE> and riccati_looped<MODE> run, for example b, the
// T-step reverse recursion of the JAX kernel `_riccati_kernel`
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
//   * box mode: k = clamp(-qu/Quu, lb, ub) with NaN passing through, the
//     active set is a bound with the gradient pointing outward, H_free =
//     Quu If + 1e-11 (:116-128); lb = max(lower - u, -delta_u) and ub =
//     min(upper - u, delta_u) are formed here from u and the bounds;
//   * zero mode: K divides by Quu (1 - I) + 1e-8 I, k by the UNMASKED Quu
//     (:129-137);
//   * V is symmetric: only its upper triangle is formed, then mirrored.
// Every entry is summed in one fixed order whatever lane computes it:
// (V F)[r][j] = V[r][0] F[0][j] + V[r][1] F[1][j] + ..., and Q[i][j] =
// C[i][j] + F[0][i] (V F)[0][j] + F[1][i] (V F)[1][j] + ..., so the box
// mode's clamp and active set see the values the one-thread kernel saw.
// k = -qu/Quu is an IEEE division (the clamp and the active set read it);
// K's divisions are a correctly rounded reciprocal and a product.
//
// The team (n = n_state + 1 <= 32, riccati_team): L lanes, L a power of two
// >= n; lane i owns row i of F, C, V, V F and Q and entry i of c and K. A
// step is three phases between team barriers: (V F) row i; Q's row i from
// column i (j >= i kept) and q[i]; the gains (every lane computes k and all
// of K from Q's column n_state, the same code on the same inputs, so the
// same bits) and V's row i for j >= i, written to row i and column i of
// the team's V, so the next step reads V mirrored. The inner loops run to
// L with no bound check: the team's memory starts zeroed and what lies past
// n stays zero, and rows are read four floats an instruction. Each lane
// loads its own rows of later steps' F, c and C (and the step's u, bounds
// or mask) into registers ahead of their use with plain loads, and writes
// its F row into a two-slot buffer in the team's shared memory at the end
// of a step; c and C stay in the lane's registers. An example-invariant C
// (T and B strides 0) is read once into the block's shared memory instead.
//
// The looped form (n > 32, riccati_looped): a team of 32 lanes loops over
// its rows (i, i + 32, ...) with the same per-entry arithmetic, its V, V F,
// Q, q and v in the team's shared memory while the block's fit in half an
// SM, past that in a device-memory scratch; C, c and F are read where they
// lie. Both places give the same bits.
//
// A phase reads only what earlier phases wrote, so the host build runs
// lanes 0..L-1 of each phase in turn and computes what the card computes
// (tests/test_torch_csrc.py, g++).
#pragma once

#include <stddef.h>

#include "kkt_fused.cuh"  // DILQR_HD, ld4, st4, rcp, DeviceTeam, HostTeam

namespace dilqr {

// gain modes; ops/cuda/riccati_fused.py MODES lists the same ids
enum RiccatiMode { kModeFree = 0, kModeBox = 1, kModeZero = 2 };

constexpr int kRicMaxLanes = 32;   // past n = 32 the looped form
constexpr int kRicSmemMax = 232448;  // shared memory a block may use
// half an SM's shared memory: the looped form's team memory stays in shared
// memory while a block needs no more, so two blocks fit an SM
constexpr int kRicSmemCap = kRicSmemMax / 2;

struct RiccatiArgs {
  int T, B, nx;
  // element (t, b, i, j) of C at t * sCt + b * sCb + i * n + j, likewise c
  // (t, b, i) and F (t, b, i, j) for t < T-1; any T and B strides (an
  // expanded, example-invariant C has sCt = sCb = 0)
  const float* C;
  long long sCt, sCb;
  const float* c;
  long long sct, scb;
  const float* F;
  long long sFt, sFb;
  // box mode: u (t, b) at t * sut + b * sub; the lower bound the number
  // lo_v, or (lo non-null) lo[t * slt + b * slb], likewise the upper; du is
  // delta_u (+inf for none)
  const float* u;
  long long sut, sub;
  const float* lo;
  long long slt, slb;
  float lo_v;
  const float* hi;
  long long sht, shb;
  float hi_v;
  float du;
  // zero mode: the u_zero_I mask's bytes (t, b) at t * szt + b * szb
  const unsigned char* uz;
  long long szt, szb;
  float* K;        // [T, B, nx] out
  float* k;        // [T, B] out
  float* scratch;  // the looped form's team memory when not in shared memory
};

// Offsets, in floats, of a team's memory. The team form: F [2][L][L] (this
// step's and the next's; rows of L floats, zero past n, rows past n_state
// zero), V and V F [L][L + 4], then Q's column n_state, q and v [L] each.
// The looped form: V [nx][nx], V F [nx][n], Q [n][n], q [n], v [nx].
struct RiccatiLayout {
  int L, looped;
  int oF;               // team form only
  int oV, oVF, oQu, oq, ov;  // oQu team form only
  int oQ;               // looped form only
  int block;            // floats of the block's area (the invariant C)
  int team;             // floats a team; 4 x an odd number
};

DILQR_HD int ric_lanes(int n) {
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : kRicMaxLanes;
}

DILQR_HD RiccatiLayout riccati_layout(int nx) {
  const int n = nx + 1;
  RiccatiLayout y{};
  y.looped = n > kRicMaxLanes;
  y.L = y.looped ? kRicMaxLanes : ric_lanes(n);
  const int L = y.L;
  int o = 0;
  if (!y.looped) {
    y.oF = o;  o += 2 * L * L;
    y.oV = o;  o += L * (L + 4);
    y.oVF = o; o += L * (L + 4);
    y.oQu = o; o += L;
    y.oq = o;  o += L;
    y.ov = o;  o += L;
    y.block = n * L;
  } else {
    y.oV = o;  o += nx * nx;
    y.oVF = o; o += nx * n;
    y.oQ = o;  o += n * n;
    y.oq = o;  o += n;
    y.ov = o;  o += nx;
    y.block = 0;
  }
  // a multiple of 4 keeps every team's memory 16-byte aligned; 4 x odd puts
  // the teams of a warp on different banks for the same offset
  o = (o + 3) / 4;
  if (o % 2 == 0) ++o;
  y.team = 4 * o;
  return y;
}

// The launch plan: out = {lanes a team, teams a block, shared bytes a block,
// 1 if the team memory is the device-memory scratch, floats a team, 1 for
// the looped form}. Returns non-zero for a block size the form does not
// take (a multiple of the lanes, 32..256 threads), or a global store asked
// of the team form, which keeps nothing there.
DILQR_HD int riccati_plan(int nx, int block, int force_global, int* out) {
  if (nx < 1 || block < 32 || block > 256 || block % 32 != 0) return 1;
  const RiccatiLayout y = riccati_layout(nx);
  const int teams = block / y.L;
  long long smem = 4LL * (y.block + (long long)teams * y.team);
  int global = 0;
  if (y.looped) {
    global = force_global || smem > kRicSmemCap;
    if (global) smem = 0;
  } else if (force_global || smem > kRicSmemMax) {
    return 1;
  }
  out[0] = y.L;
  out[1] = teams;
  out[2] = (int)smem;
  out[3] = global;
  out[4] = y.team;
  out[5] = y.looped;
  return 0;
}

// What one lane keeps from phase to phase (registers on the card).
template <int L>
struct RicLane {
  float Q[L];   // team form: row `lane` of Q (the entries j >= lane are kept)
  float Cn[L];  // team form: row `lane` of C at the next step (zero past n)
  float Fn[L];  // team form: row `lane` of F at the next step (zero past n)
  float q, cn;  // cn: entry `lane` of c at the next step
  float u, lo, hi, uz;      // this step's u, bounds and mask, as read
  float u_n, lo_n, hi_n, uz_n;  // the next step's
};

// Read step t's u and bounds (box) or mask (zero) into the lane's `_n`
// registers; the bounds are formed where they are used.
template <int MODE, class Lane>
DILQR_HD void ric_load(const RiccatiArgs& a, int t, int b, Lane& R) {
  if constexpr (MODE == kModeBox) {
    R.u_n = a.u[t * a.sut + (long long)b * a.sub];
    R.lo_n = a.lo ? a.lo[t * a.slt + (long long)b * a.slb] : a.lo_v;
    R.hi_n = a.hi ? a.hi[t * a.sht + (long long)b * a.shb] : a.hi_v;
  } else if constexpr (MODE == kModeZero) {
    R.uz_n = a.uz[t * a.szt + (long long)b * a.szb] ? 1.0f : 0.0f;
  }
}

template <class Lane>
DILQR_HD void ric_advance(Lane& R) {
  R.u = R.u_n, R.lo = R.lo_n, R.hi = R.hi_n, R.uz = R.uz_n;
}

// k (IEEE), and K[j] = -(Q[j][nx] f) r for every j. Box mode: the bounds
// lower - u and upper - u clamped by +-delta_u (NaN passes through, as
// torch.maximum/minimum let it); the two candidate reciprocals are formed
// beside the division, so only a select waits on the active set.
template <int MODE>
DILQR_HD void ric_gains(const RiccatiArgs& a, float Quu, float qu, float u, float lo_in,
                        float hi_in, float uz, float& kt, float& f, float& r) {
  if constexpr (MODE == kModeBox) {
    const float kf = -qu / Quu;
    const float r1 = rcp(Quu * 1.0f + 1e-11f), r0 = rcp(Quu * 0.0f + 1e-11f);
    const float l = lo_in - u, h = hi_in - u;
    const float lo = l < -a.du ? -a.du : l;
    const float hi = h > a.du ? a.du : h;
    kt = kf < lo ? lo : kf;  // clamp; NaN passes through as in jnp.clip
    kt = kt > hi ? hi : kt;
    const float g = Quu * kt + qu;
    const bool active = (kt <= lo && g > 0.0f) || (kt >= hi && g < 0.0f);
    f = active ? 0.0f : 1.0f;
    r = active ? r0 : r1;  // rcp(Quu f + 1e-11)
  } else if constexpr (MODE == kModeZero) {
    f = 1.0f - uz;
    kt = -(qu * f) / Quu;
    r = rcp(Quu * f + 1e-8f * uz);
  } else {
    kt = -qu / Quu;
    f = 1.0f;
    r = rcp(Quu);
  }
  (void)a, (void)u, (void)lo_in, (void)hi_in, (void)uz;
}

// V' = Qxx + Qxu K^T + K Qux + Quu K K^T, entry (i, j)
DILQR_HD float ric_v(float Qij, float Qi, float Kj, float Ki, float Qj, float Quu) {
  return Qij + Qi * Kj + Ki * Qj + Quu * Ki * Kj;
}

// The example-invariant C into the block's area [n][L], zero past n; the
// block's threads `tid` of `nthreads`, a block barrier after it on the card.
template <int L>
DILQR_HD void ric_block_C(const RiccatiArgs& a, float* Cb, int tid, int nthreads) {
  const int n = a.nx + 1;
  for (int e = tid; e < n * L; e += nthreads) {
    const int i = e / L, j = e % L;
    Cb[e] = j < n ? a.C[i * n + j] : 0.0f;
  }
}

// The team form. `Cb`: the block's invariant C (read when a.sCt = a.sCb =
// 0); `ts`: the team's shared memory; `live`: b is in the batch (a team past
// its end runs example B-1 and stores nothing).
template <int L, int MODE, int NXC, class Team>
DILQR_HD void riccati_team(const RiccatiArgs& a, const RiccatiLayout& y, int b, bool live,
                           const float* Cb, float* ts, Team& team) {
  using Lane = RicLane<L>;
  constexpr int VS = L + 4;  // V's and V F's row stride: 16-byte rows on distinct banks
  // NXC: n_state known at compile time (0: any n_state up to L - 1). The
  // loops then run over the rows of F and V that can be nonzero (MR) and
  // the columns that can be nonzero (NC), reading MC >= NC columns four at a
  // time; the arithmetic of each entry is the same.
  constexpr int MR = NXC ? NXC : L;
  constexpr int NC = NXC ? NXC + 1 : L;
  constexpr int MC = (NC + 3) / 4 * 4;
  const int T = a.T, nx = a.nx, n = nx + 1;
  const size_t B = (size_t)a.B;
  const bool cinv = a.sCt == 0 && a.sCb == 0;
  float* Vs = ts + y.oV;   // [L][VS], mirrored
  float* VF = ts + y.oVF;  // [L][VS], row m = lane m's (V F) row
  float* Qu = ts + y.oQu;  // [L], Q's column nx
  float* qs = ts + y.oq;   // [L]
  float* vs = ts + y.ov;   // [L]
  auto Fbuf = [&](int k) { return ts + y.oF + (k & 1) * L * L; };
  // lane l's entry of step t's c into R.cn and its row of C (zero past n)
  // into R.Cn; its row of F_t into R.Fn
  auto load_Cc = [&](int t, int l, Lane& R) {
    if (l < n) {
      R.cn = a.c[t * a.sct + b * a.scb + l];
      if (!cinv) {
        const float* src = a.C + t * a.sCt + b * a.sCb + l * n;
#pragma unroll
        for (int j = 0; j < MC; ++j) R.Cn[j] = j < n ? src[j] : 0.0f;
      }
    }
  };
  auto load_F = [&](int t, int l, Lane& R) {
    const float* src = a.F + t * a.sFt + b * a.sFb + l * n;
#pragma unroll
    for (int j = 0; j < MC; ++j) R.Fn[j] = l < nx && j < n ? src[j] : 0.0f;
  };

  team.phase([&](int l, Lane&) {
    for (int i = l; i < y.team; i += L) ts[i] = 0.0f;
  });
  // step T-1's c, C row and scalars, and F_{T-2}
  team.phase([&](int l, Lane& R) {
    R.u_n = R.lo_n = R.hi_n = R.uz_n = 0.0f;
    ric_load<MODE>(a, T - 1, b, R);
    load_Cc(T - 1, l, R);
    if (T > 1) load_F(T - 2, l, R);
  });
  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    const float* F = Fbuf(k);
    // the next step's u and bounds; (V F) row l, summed in ascending m
    team.phase([&](int l, Lane& R) {
      ric_advance(R);
      if (t > 0) ric_load<MODE>(a, t - 1, b, R);
      if (t < T - 1 && l < nx) {
        float Vr[L], f[L], acc[L];
#pragma unroll
        for (int q = 0; q < MR; q += 4) ld4(Vs + l * VS + q, Vr + q);
#pragma unroll
        for (int q = 0; q < MC; q += 4) ld4(F + q, f + q);
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[j] = j < NC ? Vr[0] * f[j] : 0.0f;
#pragma unroll
        for (int m = 1; m < MR; ++m) {
#pragma unroll
          for (int q = 0; q < MC; q += 4) ld4(F + m * L + q, f + q);
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[j] += Vr[m] * f[j];
        }
#pragma unroll
        for (int q = 0; q < MC; q += 4) st4(VF + l * VS + q, acc + q);
      }
    });
    // Q row l = C row l + sum_r F[r][l] (V F)[r][.], q[l] = c[l] + sum_r
    // F[r][l] v[r]; at t = T-1, C and c
    team.phase([&](int l, Lane& R) {
      if (l < n) {
        float acc[L], w[L];
        if (cinv) {
#pragma unroll
          for (int q = 0; q < MC; q += 4) ld4(Cb + l * L + q, acc + q);
        } else {
#pragma unroll
          for (int j = 0; j < MC; ++j) acc[j] = R.Cn[j];
        }
        float qq = R.cn;
        if (t > 0) load_Cc(t - 1, l, R);
        if (t < T - 1) {
          float Fc[L];
#pragma unroll
          for (int m = 0; m < MR; ++m) Fc[m] = F[m * L + l];
#pragma unroll
          for (int q = 0; q < MR; q += 4) ld4(vs + q, w + q);
#pragma unroll
          for (int m = 0; m < MR; ++m) qq += Fc[m] * w[m];
#pragma unroll
          for (int m = 0; m < MR; ++m) {
#pragma unroll
            for (int q = 0; q < MC; q += 4) ld4(VF + m * VS + q, w + q);
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[j] += Fc[m] * w[j];
          }
        }
        float qn = 0.0f;  // Q[l][nx], selected without a dynamic register index
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          R.Q[j] = acc[j];
          qn = j == nx ? acc[j] : qn;
        }
        R.q = qq;
        Qu[l] = qn;
        qs[l] = qq;
      }
    });
    // gains, V row l for j >= l (mirrored into column l) and v[l]; the next
    // step's F row into the other buffer, and F_{t-2}'s row loaded
    team.phase([&](int l, Lane& R) {
      const float Quu = Qu[nx], qu = qs[nx];
      float kt, f, r;
      ric_gains<MODE>(a, Quu, qu, R.u, R.lo, R.hi, R.uz, kt, f, r);
      if (l < nx) {
        const float Qi = Qu[l];
        const float Ki = -(Qi * f) * r;
        const float qu_plus = qu + Quu * kt;
        float Qc[L];
#pragma unroll
        for (int q = 0; q < MC; q += 4) ld4(Qu + q, Qc + q);
#pragma unroll
        for (int j = 0; j < MR; ++j) {
          if (j >= l && j < nx) {
            const float Kj = -(Qc[j] * f) * r;
            const float V = ric_v(R.Q[j], Qi, Kj, Ki, Qc[j], Quu);
            Vs[l * VS + j] = V;
            Vs[j * VS + l] = V;
          }
        }
        vs[l] = R.q + Qi * kt + Ki * qu_plus;
        if (live) a.K[((size_t)t * B + b) * nx + l] = Ki;
      }
      if (l == 0 && live) a.k[(size_t)t * B + b] = kt;
      if (t > 0) {
        if (l < nx) {
#pragma unroll
          for (int q = 0; q < MC; q += 4) st4(Fbuf(k + 1) + l * L + q, R.Fn + q);
        }
        if (t > 1) load_F(t - 2, l, R);
      }
    });
  }
}

// The looped form: a team of L = 32 lanes, rows i, i + L, ...; `ts` the
// team's memory (shared or the device-memory scratch).
template <int MODE, class Team>
DILQR_HD void riccati_looped(const RiccatiArgs& a, const RiccatiLayout& y, int b, bool live,
                             float* ts, Team& team) {
  constexpr int L = kRicMaxLanes;
  using Lane = RicLane<L>;
  const int T = a.T, nx = a.nx, n = nx + 1;
  const size_t B = (size_t)a.B;
  float* V = ts + y.oV;    // [nx][nx], mirrored
  float* VF = ts + y.oVF;  // [nx][n]
  float* Q = ts + y.oQ;    // [n][n], the entries j >= i
  float* q = ts + y.oq;    // [n]
  float* v = ts + y.ov;    // [nx]
  team.phase([&](int, Lane& R) {
    R.u_n = R.lo_n = R.hi_n = R.uz_n = 0.0f;
    ric_load<MODE>(a, T - 1, b, R);
  });
  for (int t = T - 1; t >= 0; --t) {
    const float* C = a.C + t * a.sCt + b * a.sCb;
    const float* c = a.c + t * a.sct + b * a.scb;
    const float* F = a.F + (t < T - 1 ? t * a.sFt + b * a.sFb : 0);
    team.phase([&](int l, Lane& R) {
      ric_advance(R);
      if (t > 0) ric_load<MODE>(a, t - 1, b, R);
      if (t < T - 1) {
        for (int r = l; r < nx; r += L)
          for (int j = 0; j < n; ++j) {
            float s = V[r * nx] * F[j];
            for (int m = 1; m < nx; ++m) s += V[r * nx + m] * F[m * n + j];
            VF[r * n + j] = s;
          }
      }
    });
    team.phase([&](int l, Lane&) {
      for (int i = l; i < n; i += L) {
        float qq = c[i];
        if (t < T - 1)
          for (int m = 0; m < nx; ++m) qq += F[m * n + i] * v[m];
        q[i] = qq;
        for (int j = i; j < n; ++j) {
          float s = C[i * n + j];
          if (t < T - 1)
            for (int r = 0; r < nx; ++r) s += F[r * n + i] * VF[r * n + j];
          Q[i * n + j] = s;
        }
      }
    });
    team.phase([&](int l, Lane& R) {
      const float Quu = Q[nx * n + nx], qu = q[nx];
      float kt, f, r;
      ric_gains<MODE>(a, Quu, qu, R.u, R.lo, R.hi, R.uz, kt, f, r);
      const float qu_plus = qu + Quu * kt;
      for (int i = l; i < nx; i += L) {
        const float Qi = Q[i * n + nx];
        const float Ki = -(Qi * f) * r;
        for (int j = i; j < nx; ++j) {
          const float Qj = Q[j * n + nx];
          const float Kj = -(Qj * f) * r;
          const float Vij = ric_v(Q[i * n + j], Qi, Kj, Ki, Qj, Quu);
          V[i * nx + j] = Vij;
          V[j * nx + i] = Vij;
        }
        v[i] = q[i] + Qi * kt + Ki * qu_plus;
        if (live) a.K[((size_t)t * B + b) * nx + i] = Ki;
      }
      if (l == 0 && live) a.k[(size_t)t * B + b] = kt;
    });
  }
}

// Calls f(RicShape<L, NXC>) with the team form's lanes for n_state nx and
// its compile-time n_state (NXC: 5 and 6, the learned cartpole model's and
// the slew-rate cartpole's, the main paths' sizes; 0 for any other), or
// f(RicShape<0, 0>) for the looped form.
template <int L_, int NXC_>
struct RicShape {
  static constexpr int L = L_, NXC = NXC_;
};

template <class Fn>
int riccati_dispatch(int nx, Fn&& f) {
  const int n = nx + 1;
  if (n <= 4) return f(RicShape<4, 0>{});
  if (nx == 5) return f(RicShape<8, 5>{});
  if (nx == 6) return f(RicShape<8, 6>{});
  if (n <= 8) return f(RicShape<8, 0>{});
  if (n <= 16) return f(RicShape<16, 0>{});
  if (n <= kRicMaxLanes) return f(RicShape<32, 0>{});
  return f(RicShape<0, 0>{});
}

}  // namespace dilqr
