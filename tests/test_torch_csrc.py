"""The kernels' per-example device code, built for the host.

csrc/ilqr_fused.cuh holds the env steps, Jacobians, the objective, the
multi-control box-QP (closed-form inverses, the projected-Newton step and
its loop), the rocket's Riccati step over strided storage and cos_sin,
csrc/kkt_fused.cuh the whole per-example KKT VJP of a lane team (its
phases run lane by lane here) and
csrc/riccati_fused.cuh the per-example reverse Riccati, as
__host__ __device__ functions; g++ compiles them here (no nvcc needed) into
a small ctypes library. The learned model's Mlp and JvpJac<Mlp> are held
against the port's kernel_step and its jvp sweep at f64 (the step on
double and DualOf<double>) and at f32 (the kernel's own code), with relu
and elu at pre-activations of exactly 0. The env code is held against the port's Python
kernel forms (Dynamics.kernel_step, Dynamics.jac_lanes) on the same f32
inputs, the box-QP against the plain version's (ilqr_fused._pnqp_tiles
with one example a tile: built for the host, the device code's tile vote is
one example's own decision), the KKT code against kkt_fused_reference,
the Riccati code against riccati_fused_reference.
Tolerance 2e-6 on values of order one for the env code (relative to the
largest entry for the rocket's larger ones): the host build takes 1/sqrtf
for rsqrtf and may contract to FMAs, a few ulp apart from PyTorch's
evaluation order; 1e-5 relative for the inverses and the box-QP, whose
Newton steps carry that rounding along; 1e-5 relative to the largest output
for the KKT VJP and the Riccati, whose T-step recursions do too."""
import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.func import jacfwd

from dilqr_tpu_torch.models import cartpole, ctrl_passthrough, nn_dynamics, pendulum, rocket
from dilqr_tpu_torch.ops.cuda import ilqr_fused, kkt_fused
from dilqr_tpu_torch.ops.cuda import riccati_fused
from dilqr_tpu_torch.utils.batch import inv_small
from rocket_bench_start import bench_start

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dilqr_tpu_torch", "csrc")

SHIM = r"""
#include <cmath>
#include <vector>
#include "ilqr_fused.cuh"
#include "kkt_fused.cuh"
#include "riccati_fused.cuh"
using namespace dilqr;
template <class Env>
static void run(const float* p, const float* x, const float* u, int B,
                float* xn, float* D) {
  constexpr int NX = Env::NX, N = Env::NX + Env::NU;
  Env env;
  env.load(p);
  for (int b = 0; b < B; ++b) {
    env.step(x + b * NX, u + b * Env::NU, xn + b * NX);
    float J[NX][N];
    env.jac(x + b * NX, u + b * Env::NU, J);
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < N; ++j) D[(b * NX + i) * N + j] = J[i][j];
  }
}
extern "C" void env_eval(int env, const float* p, const float* x, const float* u, int B,
                         float* xn, float* D) {
  if (env == ENV_CARTPOLE) run<Cartpole>(p, x, u, B, xn, D);
  else if (env == ENV_PENDULUM) run<Pendulum>(p, x, u, B, xn, D);
  else if (env == ENV_ROCKET) run<Rocket>(p, x, u, B, xn, D);
  else if (env == ENV_CARTPOLE_SLEW) run<Passthrough<Cartpole>>(p, x, u, B, xn, D);
  else if (env == ENV_PENDULUM_SLEW) run<Passthrough<Pendulum>>(p, x, u, B, xn, D);
  else run<Passthrough<Rocket>>(p, x, u, B, xn, D);
}
template <int M>
static void qp_run(int B, const float* H, const float* q, const float* lb, const float* ub,
                   const float* x0, int n_iter, float* x, float* If, float* Hf, float* Hinv,
                   float* obj) {
  for (int b = 0; b < B; ++b) {
    float Hb[M][M], Hfb[M][M], Hib[M][M];
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < M; ++j) Hb[i][j] = H[(b * M + i) * M + j];
    const int o = b * M;
    TileVote vote{nullptr, 0};
    pnqp<M>(Hb, q + o, lb + o, ub + o, x0 + o, n_iter, vote, x + o, If + o, Hfb);
    inv_small<M>(Hb, Hib);
    obj[b] = qp_obj<M>(Hb, q + o, x0 + o);
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < M; ++j) {
        Hf[(b * M + i) * M + j] = Hfb[i][j];
        Hinv[(b * M + i) * M + j] = Hib[i][j];
      }
  }
}
extern "C" int qp_eval(int m, int B, const float* H, const float* q, const float* lb,
                       const float* ub, const float* x0, int n_iter, float* x, float* If,
                       float* Hf, float* Hinv, float* obj) {
  if (m == 2) qp_run<2>(B, H, q, lb, ub, x0, n_iter, x, If, Hf, Hinv, obj);
  else if (m == 3) qp_run<3>(B, H, q, lb, ub, x0, n_iter, x, If, Hf, Hinv, obj);
  else return 1;
  return 0;
}
extern "C" void cos_sin_eval(int n, const float* x, float* c, float* s) {
  for (int i = 0; i < n; ++i) cos_sin(x[i], c + i, s + i);
}
// BoxStepLayout of Env: kV, kQ, kF, kFloats, kSplit, kScratch
template <class Env>
static void layout_of(int* out) {
  using L = BoxStepLayout<Env, Env::NU>;
  out[0] = L::kV;
  out[1] = L::kQ;
  out[2] = L::kF;
  out[3] = L::kFloats;
  out[4] = L::kSplit;
  out[5] = L::kScratch;
}
extern "C" void box_layout(int env, int* out) {
  if (env == ENV_ROCKET) layout_of<Rocket>(out);
  else layout_of<Passthrough<Rocket>>(out);
}
// the Riccati step of the rocket (env 2) or its slew-rate wrapper (env 5)
// per example, each example its own tile; store [kFloats, B] holds V's
// triangle (in, out) and Q (out; without Quu in the split layout), F (out)
// is in the store or, in the split layout, in fscratch [(NX+1)*N, B] (F,
// then q); quu [NU*NU, B] (out) is Quu as the box-QP takes it. The cost
// is one [N*N] C and [N] c, or per example (c_lanes) C [N*N, B], c [N, B];
// lo/hi are per example [B, NU]; Iz null or the mask [B, NU] of an unboxed
// solve.
template <class Env>
static void box_run(int B, int last, const float* p, const float* tau, const float* C,
                    const float* c, int c_lanes, const float* lo, const float* hi, int has_du,
                    float du, const float* Iz, const float* warm, int n_iter, float* store,
                    float* fscratch, float* quu, float* v, float* K, float* k, int* votes) {
  constexpr int NX = Env::NX, NU = Env::NU, N = NX + NU;
  Env env;
  env.load(p);
  for (int b = 0; b < B; ++b) {
    TileVote vote{nullptr, 0};
    float Kb[NU][NX];
    const CostView cost = c_lanes ? CostView{C + b, c + b, B} : CostView{C, c, 1};
    StepVariant<NU> var{has_du, du, Iz != nullptr, {}};
    for (int r = 0; Iz && r < NU; ++r) var.Iz[r] = Iz[b * NU + r];
    riccati_box_step<Env, NU>(env, last != 0, tau + b * N, cost, lo + b * NU, hi + b * NU, var,
                              warm + b * NU, n_iter, vote, store + b, B, fscratch + b, B,
                              v + b * NX, Kb, k + b * NU, Strided{quu + b, B});
    for (int r = 0; r < NU; ++r)
      for (int j = 0; j < NX; ++j) K[(b * NU + r) * NX + j] = Kb[r][j];
    votes[b] = vote.n;
  }
}
extern "C" void box_step_host(int env, int B, int last, const float* p, const float* tau,
                              const float* C, const float* c, int c_lanes, const float* lo,
                              const float* hi, int has_du, float du, const float* Iz,
                              const float* warm, int n_iter, float* store, float* fscratch,
                              float* quu, float* v, float* K, float* k, int* votes) {
  if (env == ENV_ROCKET)
    box_run<Rocket>(B, last, p, tau, C, c, c_lanes, lo, hi, has_du, du, Iz, warm, n_iter, store,
                    fscratch, quu, v, K, k, votes);
  else
    box_run<Passthrough<Rocket>>(B, last, p, tau, C, c, c_lanes, lo, hi, has_du, du, Iz, warm,
                                 n_iter, store, fscratch, quu, v, K, k, votes);
}
// inv_small<M> of B matrices [B, M, M]
template <int M>
static void inv_run(int B, const float* A, float* R) {
  for (int b = 0; b < B; ++b) {
    float Ab[M][M], Rb[M][M];
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < M; ++j) Ab[i][j] = A[(b * M + i) * M + j];
    inv_small<M>(Ab, Rb);
    for (int i = 0; i < M; ++i)
      for (int j = 0; j < M; ++j) R[(b * M + i) * M + j] = Rb[i][j];
  }
}
extern "C" int inv_eval(int m, int B, const float* A, float* R) {
  switch (m) {
    case 1: inv_run<1>(B, A, R); return 0;
    case 2: inv_run<2>(B, A, R); return 0;
    case 3: inv_run<3>(B, A, R); return 0;
    case 4: inv_run<4>(B, A, R); return 0;
    case 5: inv_run<5>(B, A, R); return 0;
    case 6: inv_run<6>(B, A, R); return 0;
    case 7: inv_run<7>(B, A, R); return 0;
    case 8: inv_run<8>(B, A, R); return 0;
    default: return 1;
  }
}
// the LinDx shapes built here: (1,1), (3,2), (5,2), (9,1), (4,5), (4,8),
// (15,2)
template <class F>
static int lindx_shape(int nx, int nu, F f) {
  if (nx == 1 && nu == 1) return f(LinDx<1, 1>{});
  if (nx == 3 && nu == 2) return f(LinDx<3, 2>{});
  if (nx == 15 && nu == 2) return f(LinDx<15, 2>{});
  if (nx == 5 && nu == 2) return f(LinDx<5, 2>{});
  if (nx == 9 && nu == 1) return f(LinDx<9, 1>{});
  if (nx == 4 && nu == 5) return f(LinDx<4, 5>{});
  if (nx == 4 && nu == 8) return f(LinDx<4, 8>{});
  return 1;
}
// LinDx<NX, NU>'s step and Jacobian at step t of F [T-1, NX*N, B] and f
// [T-1, NX, B] (or null), each example b its own column
extern "C" int lindx_eval(int nx, int nu, int t, int B, const float* F, const float* f,
                          const float* x, const float* u, float* xn, float* D) {
  return lindx_shape(nx, nu, [&](auto e) {
    using Env = decltype(e);
    constexpr int NX = Env::NX, NU = Env::NU, N = NX + NU;
    for (int b = 0; b < B; ++b) {
      Env env;
      env.load(nullptr);
      env.bind(F, f, B, b);
      env.at(t);
      env.step(x + b * NX, u + b * NU, xn + b * NX);
      float J[NX][N];
      env.jac(x + b * NX, u + b * NU, J);
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < N; ++j) D[(b * NX + i) * N + j] = J[i][j];
    }
    return 0;
  });
}
// riccati_box_step of LinDx<NX, NU> per example (each its own tile), with
// F [1, NX*N, B] (step 0) unless `last`, the example-invariant cost C [N*N]
// and c [N], per-example bounds lo/hi [B, NU], the warm start [B, NU];
// store [kFloats, B] holds V's triangle (in, out), Q and F (out; in the
// split layout Q without Quu), fscratch [(NX+1)*N, B] F and q in the split
// layout (out); quu [NU*NU, B] (out) is Quu as the box-QP takes it;
// layout[6] as layout_of's
extern "C" int lindx_box_step(int nx, int nu, int B, int last, const float* F,
                              const float* tau, const float* C, const float* c,
                              const float* lo, const float* hi, const float* warm, int n_iter,
                              float* store, float* fscratch, float* quu, float* v, float* K,
                              float* k, int* layout) {
  return lindx_shape(nx, nu, [&](auto e) {
    using Env = decltype(e);
    constexpr int NX = Env::NX, NU = Env::NU, N = NX + NU;
    layout_of<Env>(layout);
    for (int b = 0; b < B; ++b) {
      Env env;
      env.bind(F, nullptr, B, b);
      env.at(0);
      TileVote vote{nullptr, 0};
      float Kb[NU][NX];
      StepVariant<NU> var{0, 0.0f, 0, {}};
      riccati_box_step<Env, NU>(env, last != 0, tau + b * N, CostView{C, c, 1}, lo + b * NU,
                                hi + b * NU, var, warm + b * NU, n_iter, vote, store + b, B,
                                fscratch + b, B, v + b * NX, Kb, k + b * NU,
                                Strided{quu + b, B});
      for (int r = 0; r < NU; ++r)
        for (int j = 0; j < NX; ++j) K[(b * NU + r) * NX + j] = Kb[r][j];
    }
    return 0;
  });
}
extern "C" float objective6(const float* tau, const float* C, const float* c) {
  return objective<6>(tau, CostView{C, c, 1});
}
// the KKT VJP of each example on the host: the team's lanes run each
// phase in turn; global_store puts K, k and dtau in `store` [T, B, KS]
extern "C" int kkt_host(int nx, int nu, int T, int B, int global_store, const float* slab,
                        const float* gx, const float* gu, float* dF, float* df, float* dxi,
                        float* dC, float* dc, float* store) {
  return kkt_dispatch(nx, nu, [&](auto s) {
    constexpr int NU = decltype(s)::NU, L = decltype(s)::L;
    const KktLayout y = kkt_layout<NU, L>(nx, T, global_store == 0);
    const KktArgs a{T, B, slab, gx, (long long)B * nx, nx, gu, (long long)B * NU, NU,
                    dF, df, dxi, dC, dc, global_store ? store : nullptr};
    std::vector<float> team(y.team);
    for (int b = 0; b < B; ++b) {
      HostTeam<KktLane<NU, L>, L> tm;
      kkt_example<NU, L>(a, y, b, team.data(), tm);
    }
    return L;
  });
}
template <int L, int NXC, int MODE>
static void ric_run(const RiccatiArgs& a, const int* p) {
  // one block's shared memory at a time, teams in turn, as the card runs them
  const RiccatiLayout y = riccati_layout(a.nx);
  const int teams = p[1];
  for (int g0 = 0; g0 < a.B; g0 += teams) {
    std::vector<float> smem(p[2] / 4 + 4);
    if constexpr (L == 0) {
      for (int e = 0; e < teams; ++e) {
        const int g = g0 + e;
        HostTeam<RicLane<kRicMaxLanes>, kRicMaxLanes> tm;
        float* ts = a.scratch ? a.scratch + (size_t)g * y.team : smem.data() + (size_t)e * y.team;
        riccati_looped<MODE>(a, y, g < a.B ? g : a.B - 1, g < a.B, ts, tm);
      }
    } else {
      if (a.sCt == 0 && a.sCb == 0) ric_block_C<L>(a, smem.data(), 0, 1);
      for (int e = 0; e < teams; ++e) {
        const int g = g0 + e;
        HostTeam<RicLane<L>, L> tm;
        riccati_team<L, MODE, NXC>(a, y, g < a.B ? g : a.B - 1, g < a.B, smem.data(),
                              smem.data() + y.block + (size_t)e * y.team, tm);
      }
    }
  }
}
// JvpJac<Env, Clamped>: the step (float) and the jvp sweep's Jacobian of
// each device env id, the slew-rate wrappers as Passthrough<JvpJac<...>>
template <class Env, bool Clamped>
static void jvp_run(const float* p, const float* x, const float* u, int B, float* xn,
                    float* D) {
  run<JvpJac<Env, Clamped>>(p, x, u, B, xn, D);
}
template <class Env, bool Clamped>
static void jvp_slew_run(const float* p, const float* x, const float* u, int B, float* xn,
                         float* D) {
  run<Passthrough<JvpJac<Env, Clamped>>>(p, x, u, B, xn, D);
}
template <bool C>
static int jvp_env(int env, const float* p, const float* x, const float* u, int B, float* xn,
                   float* D) {
  switch (env) {
    case ENV_CARTPOLE: jvp_run<Cartpole, C>(p, x, u, B, xn, D); return 0;
    case ENV_PENDULUM: jvp_run<Pendulum, C>(p, x, u, B, xn, D); return 0;
    case ENV_ROCKET: jvp_run<Rocket, C>(p, x, u, B, xn, D); return 0;
    case ENV_PENDULUM_COMPLEX: jvp_run<PendulumComplex, C>(p, x, u, B, xn, D); return 0;
    case ENV_ROCKET_NORM: jvp_run<RocketNorm, C>(p, x, u, B, xn, D); return 0;
    case ENV_CARTPOLE_SLEW: jvp_slew_run<Cartpole, C>(p, x, u, B, xn, D); return 0;
    case ENV_PENDULUM_SLEW: jvp_slew_run<Pendulum, C>(p, x, u, B, xn, D); return 0;
    case ENV_ROCKET_SLEW: jvp_slew_run<Rocket, C>(p, x, u, B, xn, D); return 0;
    case ENV_PENDULUM_COMPLEX_SLEW: jvp_slew_run<PendulumComplex, C>(p, x, u, B, xn, D); return 0;
    case ENV_ROCKET_NORM_SLEW: jvp_slew_run<RocketNorm, C>(p, x, u, B, xn, D); return 0;
    default: return 1;
  }
}
extern "C" int jvp_eval(int env, int clamped, const float* p, const float* x, const float* u,
                        int B, float* xn, float* D) {
  return clamped ? jvp_env<true>(env, p, x, u, B, xn, D) : jvp_env<false>(env, p, x, u, B, xn, D);
}
// The float steps as they were written before they became templates over
// the scalar type (the same expressions, float throughout): the templated
// step<float> must give their bits.
namespace legacy {
static void rotate_cs(float c, float s, float delta, float* oc, float* os) {
  float cd, sd;
  cos_sin(delta, &cd, &sd);
  const float ct = c * cd - s * sd;
  const float st = s * cd + c * sd;
  const float nn = ct * ct + st * st;
  const float r = rsqrt_f(fmaxf(nn, 1e-30f));
  const bool zero = nn == 0.0f;
  *oc = zero ? cd : ct * r;
  *os = zero ? sd : st * r;
}
static void cartpole(const float* p, const float* xs, const float* us, float* xn) {
  const float g = p[0], mc = p[1], mp = p[2], l = p[3];
  const float u = us[0];
  const float uu = u > 100.0f ? 100.0f : (u < -100.0f ? -100.0f : u);
  const float tm = mp + mc;
  const float pml = mp * l;
  const float x = xs[0], dx = xs[1], c = xs[2], s = xs[3], w = xs[4];
  const float cart_in = (uu + pml * (w * w) * s) / tm;
  const float th_acc = (g * s - c * cart_in) / (l * (4.0f / 3.0f - mp * (c * c) / tm));
  const float xacc = cart_in - pml * th_acc * c / tm;
  xn[0] = x + kDt * dx;
  xn[1] = dx + kDt * xacc;
  rotate_cs(c, s, kDt * w, &xn[2], &xn[3]);
  xn[4] = w + kDt * th_acc;
}
static void pendulum(const float* p, const float* xs, const float* us, float* xn) {
  const float g = p[0], m = p[1], l = p[2];
  const float u = us[0];
  const float uu = u > 2.0f ? 2.0f : (u < -2.0f ? -2.0f : u);
  const float c = xs[0], s = xs[1], w = xs[2];
  const float newdth = w + kDt * (-3.0f * g / (2.0f * l) * (-s) + 3.0f * uu / (m * (l * l)));
  rotate_cs(c, s, newdth * kDt, &xn[0], &xn[1]);
  xn[2] = newdth;
}
static void rocket(const float* p, const float* xs, const float* us, float* xn) {
  const float Jx = p[0], Jy = p[1], Jz = p[2], mass = p[3], l = p[4];
  float Tb[3];
  for (int i = 0; i < 3; ++i) {
    const float u = us[i];
    Tb[i] = u > 400.0f ? 400.0f : (u < -400.0f ? -400.0f : u);
  }
  const float q0 = xs[6], q1 = xs[7], q2 = xs[8], q3 = xs[9];
  const float w0 = xs[10], w1 = xs[11], w2 = xs[12];
  float c[3][3];
  c[0][0] = 1.0f - 2.0f * (q2 * q2 + q3 * q3);
  c[0][1] = 2.0f * (q1 * q2 + q0 * q3);
  c[0][2] = 2.0f * (q1 * q3 - q0 * q2);
  c[1][0] = 2.0f * (q1 * q2 - q0 * q3);
  c[1][1] = 1.0f - 2.0f * (q1 * q1 + q3 * q3);
  c[1][2] = 2.0f * (q2 * q3 + q0 * q1);
  c[2][0] = 2.0f * (q1 * q3 + q0 * q2);
  c[2][1] = 2.0f * (q2 * q3 - q0 * q1);
  c[2][2] = 1.0f - 2.0f * (q1 * q1 + q2 * q2);
  float dx[13];
  dx[0] = xs[3];
  dx[1] = xs[4];
  dx[2] = xs[5];
  const float g[3] = {-10.0f, 0.0f, 0.0f};
  for (int i = 0; i < 3; ++i)
    dx[3 + i] = (c[0][i] * Tb[0] + c[1][i] * Tb[1] + c[2][i] * Tb[2]) / mass + g[i];
  dx[6] = 0.5f * (-w0 * q1 - w1 * q2 - w2 * q3);
  dx[7] = 0.5f * (w0 * q0 + w2 * q2 - w1 * q3);
  dx[8] = 0.5f * (w1 * q0 - w2 * q1 + w0 * q3);
  dx[9] = 0.5f * (w2 * q0 + w1 * q1 - w0 * q2);
  const float a = -0.5f * l;
  const float tq1 = -a * Tb[2];
  const float tq2 = a * Tb[1];
  const float cw0 = w1 * (Jz * w2) - w2 * (Jy * w1);
  const float cw1 = w2 * (Jx * w0) - w0 * (Jz * w2);
  const float cw2 = w0 * (Jy * w1) - w1 * (Jx * w0);
  dx[10] = (0.0f - cw0) / Jx;
  dx[11] = (tq1 - cw1) / Jy;
  dx[12] = (tq2 - cw2) / Jz;
  for (int i = 0; i < 13; ++i) xn[i] = xs[i] + dx[i] * 0.1f;
}
}  // namespace legacy
extern "C" int legacy_step(int env, const float* p, const float* x, const float* u, int B,
                           float* xn) {
  const int nx = env == ENV_CARTPOLE ? 5 : (env == ENV_PENDULUM ? 3 : 13);
  const int nu = env == ENV_ROCKET ? 3 : 1;
  for (int b = 0; b < B; ++b) {
    if (env == ENV_CARTPOLE) legacy::cartpole(p, x + b * nx, u + b * nu, xn + b * nx);
    else if (env == ENV_PENDULUM) legacy::pendulum(p, x + b * nx, u + b * nu, xn + b * nx);
    else if (env == ENV_ROCKET) legacy::rocket(p, x + b * nx, u + b * nu, xn + b * nx);
    else return 1;
  }
  return 0;
}
// The operations of one step evaluation (the jvp sweep's bound in
// chip_smoke.py, ilqr_fused.STEP_OPS): tally::F is a float that counts each
// arithmetic operation it takes part in, as a tangent operation where an
// operand holds a tangent or was computed from one (the work of one column
// of JvpJac) and as a value operation otherwise (computed once for the
// columns); tally::D is a double that counts cos_sin's operations. A
// division, a square root, rsqrt, fmax or atan2 counts one, an FMA two, a
// sign flip, a comparison or a select none.
namespace tally {
struct Counts {
  long f32, f64, tangent;
};
static Counts n;
struct F {
  float v;
  bool t;  // holds a tangent, or was computed from one
  F() = default;
  F(float x, bool tangent = false) : v(x), t(tangent) {}
};
static F op(F a, F b, float r) {
  (a.t || b.t ? n.tangent : n.f32) += 1;
  return F(r, a.t || b.t);
}
inline F operator+(F a, F b) { return op(a, b, a.v + b.v); }
inline F operator-(F a, F b) { return op(a, b, a.v - b.v); }
inline F operator*(F a, F b) { return op(a, b, a.v * b.v); }
inline F operator/(F a, F b) { return op(a, b, a.v / b.v); }
inline F operator-(F a) { return F(-a.v, a.t); }
inline bool operator<(F a, F b) { return a.v < b.v; }
inline bool operator>(F a, F b) { return a.v > b.v; }
inline bool operator>=(F a, F b) { return a.v >= b.v; }
inline bool operator==(F a, F b) { return a.v == b.v; }
inline F sqrtf(F a) { return op(a, a, std::sqrt(a.v)); }
inline F rsqrt_f(F a) { return op(a, a, 1.0f / std::sqrt(a.v)); }
inline F fmaxf(F a, F b) { return op(a, b, std::fmax(a.v, b.v)); }
inline F atan2f(F y, F x) { return op(y, x, std::atan2(y.v, x.v)); }
struct D {
  double v;
  D() = default;
  D(double x) : v(x) {}
  explicit operator float() const { return (float)v; }
};
inline D operator+(D a, D b) { ++n.f64; return a.v + b.v; }
inline D operator-(D a, D b) { ++n.f64; return a.v - b.v; }
inline D operator*(D a, D b) { ++n.f64; return a.v * b.v; }
inline D operator-(D a) { return -a.v; }
inline bool operator==(D a, D b) { return a.v == b.v; }
inline D rint(D a) { ++n.f64; return std::rint(a.v); }
inline D floor(D a) { ++n.f64; return std::floor(a.v); }
inline D fma(D a, D b, D c) { n.f64 += 2; return std::fma(a.v, b.v, c.v); }
inline void cos_sin(F x, F* c, F* s) {
  float cf, sf;
  dilqr::cos_sin<D>(x.v, &cf, &sf);
  *c = F(cf);
  *s = F(sf);
}
// the float overloads the steps call by name
inline F sqrt_s(F a) { return sqrtf(a); }
inline F rsqrt_s(F a) { return rsqrt_f(a); }
inline F fmax_s(F a, float b) { return fmaxf(a, F(b)); }
inline F atan2_s(F y, F x) { return atan2f(y, x); }
inline void cos_sin_s(F a, F* c, F* s) { cos_sin(a, c, s); }
// the MLP's activations call these (an exp counts one)
inline F exp_s(F a) { return op(a, a, std::exp(a.v)); }
inline F expm1_s(F a) { return op(a, a, std::expm1(a.v)); }
}  // namespace tally
// out: the float step's FP32 and FP64 operations, then the Dual step's FP32
// value, FP64 and FP32 tangent operations, at the point (x, u)
template <class Env, bool C>
static void count_ops(const float* p, const float* x, const float* u, long* out) {
  using tally::F;
  using DF = DualOf<F>;
  Env env;
  env.load(p);
  F xf[Env::NX], uf[Env::NU], xnf[Env::NX];
  DF xd[Env::NX], ud[Env::NU], xnd[Env::NX];
  for (int i = 0; i < Env::NX; ++i) {
    xf[i] = F(x[i]);
    xd[i] = DF(F(x[i]), F(0.0f, true));
  }
  for (int r = 0; r < Env::NU; ++r) {
    uf[r] = F(u[r]);
    ud[r] = DF(F(u[r]), F(0.0f, true));
  }
  tally::n = {};
  env.template step<C>(xf, uf, xnf);
  out[0] = tally::n.f32 + tally::n.tangent;
  out[1] = tally::n.f64;
  tally::n = {};
  env.template step<C>(xd, ud, xnd);
  out[2] = tally::n.f32;
  out[3] = tally::n.f64;
  out[4] = tally::n.tangent;
}
extern "C" int step_ops(int env, int clamped, const float* p, const float* x, const float* u,
                        long* out) {
  switch (env * 2 + clamped) {
    case ENV_CARTPOLE * 2: count_ops<Cartpole, false>(p, x, u, out); return 0;
    case ENV_CARTPOLE * 2 + 1: count_ops<Cartpole, true>(p, x, u, out); return 0;
    case ENV_PENDULUM * 2: count_ops<Pendulum, false>(p, x, u, out); return 0;
    case ENV_PENDULUM * 2 + 1: count_ops<Pendulum, true>(p, x, u, out); return 0;
    case ENV_ROCKET * 2: count_ops<Rocket, false>(p, x, u, out); return 0;
    case ENV_ROCKET * 2 + 1: count_ops<Rocket, true>(p, x, u, out); return 0;
    case ENV_PENDULUM_COMPLEX * 2: count_ops<PendulumComplex, false>(p, x, u, out); return 0;
    case ENV_PENDULUM_COMPLEX * 2 + 1: count_ops<PendulumComplex, true>(p, x, u, out); return 0;
    case ENV_ROCKET_NORM * 2: count_ops<RocketNorm, false>(p, x, u, out); return 0;
    case ENV_ROCKET_NORM * 2 + 1: count_ops<RocketNorm, true>(p, x, u, out); return 0;
    default: return 1;
  }
}
template <class Env>
constexpr bool is_mlp = false;
template <int NX, int NU, int ACT, bool R, int... H>
constexpr bool is_mlp<Mlp<NX, NU, ACT, R, H...>> = true;
// The learned model's device code (Mlp, JvpJac<Mlp>) at the shapes the
// tests take, by index: (3,1,(8,)) sigmoid, (3,1,(6,6)) relu, (3,1,(8,))
// elu, (3,2,(16,)) sigmoid (the golden's), (13,3,(8,)) sigmoid, all with the
// residual; (3,1,()) elu and (4,2,(5,3)) relu without it. 7: the slew-rate
// wrapper Passthrough<JvpJac<Mlp>> of the golden's shape. 8: the learned
// cartpole model (5,1,(100,)) sigmoid with the residual.
template <class F>
static int mlp_dispatch(int which, F f) {
  switch (which) {
    case 0: return f(Mlp<3, 1, MLP_SIGMOID, true, 8>{});
    case 1: return f(Mlp<3, 1, MLP_RELU, true, 6, 6>{});
    case 2: return f(Mlp<3, 1, MLP_ELU, true, 8>{});
    case 3: return f(Mlp<3, 2, MLP_SIGMOID, true, 16>{});
    case 4: return f(Mlp<13, 3, MLP_SIGMOID, true, 8>{});
    case 5: return f(Mlp<3, 1, MLP_ELU, false>{});
    case 6: return f(Mlp<4, 2, MLP_RELU, false, 5, 3>{});
    case 7: return f(Passthrough<JvpJac<Mlp<3, 2, MLP_SIGMOID, true, 16>, false>>{});
    case 8: return f(Mlp<5, 1, MLP_SIGMOID, true, 100>{});
    default: return 1;
  }
}
// per example: the f32 step and JvpJac's [NX][N] (the kernel's code), and
// the step at f64 with its n columns from the step on DualOf<double> (the
// net only, not the wrapper); returns NP, the weights the net reads
extern "C" int mlp_eval(int which, const float* w, const double* x, const double* u, int B,
                        float* xn32, float* D32, double* xn64, double* D64) {
  return mlp_dispatch(which, [&](auto env) {
    using Env = decltype(env);
    constexpr int NX = Env::NX, NU = Env::NU, N = NX + NU;
    JvpJac<Env, false> jv;
    env.load(w);
    jv.load(w);
    for (int b = 0; b < B; ++b) {
      float xf[NX], uf[NU], J[NX][N];
      for (int i = 0; i < NX; ++i) xf[i] = (float)x[b * NX + i];
      for (int r = 0; r < NU; ++r) uf[r] = (float)u[b * NU + r];
      env.step(xf, uf, xn32 + b * NX);
      if constexpr (is_mlp<Env>) {
        jv.jac(xf, uf, J);
      } else {
        env.jac(xf, uf, J);
      }
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < N; ++j) D32[(b * NX + i) * N + j] = J[i][j];
      if constexpr (is_mlp<Env>) {
        env.step(x + b * NX, u + b * NU, xn64 + b * NX);
        for (int j = 0; j < N; ++j) {
          DualOf<double> xd[NX], ud[NU], o[NX];
          for (int i = 0; i < NX; ++i) xd[i] = DualOf<double>(x[b * NX + i], i == j ? 1.0 : 0.0);
          for (int r = 0; r < NU; ++r)
            ud[r] = DualOf<double>(u[b * NU + r], NX + r == j ? 1.0 : 0.0);
          env.step(xd, ud, o);
          for (int i = 0; i < NX; ++i) D64[(b * NX + i) * N + j] = o[i].d;
        }
      }
    }
    return Env::NP;
  });
}
// BoxStepLayout (layout_of) of the kernel's env on the MLP `which`: its
// JvpJac, or the wrapper (7) as it stands
extern "C" int mlp_layout(int which, int* out) {
  return mlp_dispatch(which, [&](auto env) {
    using Env = decltype(env);
    if constexpr (is_mlp<Env>) {
      layout_of<JvpJac<Env, false>>(out);
    } else {
      layout_of<Env>(out);
    }
    return 0;
  });
}
// per example: the hand Jacobian (Mlp::jac, one hidden layer) at f64 and at
// f32 (the kernel's code), and Passthrough<Mlp>'s at f32 (x: the wrapper's
// state (u_{t-1}, x) when `slew`); returns NP, or -1 for a net it does not
// hold
extern "C" int mlp_hand_jac(int which, int slew, const float* w, const double* x,
                            const double* u, int B, double* D64, float* D32) {
  return mlp_dispatch(which, [&](auto env) {
    using Env = decltype(env);
    if constexpr (is_mlp<Env>) {
      if constexpr (Env::kLayers == 2) {
        constexpr int NX = Env::NX, NU = Env::NU, N = NX + NU;
        env.load(w);
        Passthrough<Env> pt;
        pt.load(w);
        constexpr int NA = NX + NU, MA = NA + NU;
        for (int b = 0; b < B; ++b) {
          if (slew) {
            float xf[NA], uf[NU], J[NA][MA];
            for (int i = 0; i < NA; ++i) xf[i] = (float)x[b * NA + i];
            for (int r = 0; r < NU; ++r) uf[r] = (float)u[b * NU + r];
            pt.jac(xf, uf, J);
            for (int i = 0; i < NA; ++i)
              for (int j = 0; j < MA; ++j) D32[(b * NA + i) * MA + j] = J[i][j];
            continue;
          }
          double J64[NX][N];
          float xf[NX], uf[NU], J32[NX][N];
          env.jac(x + b * NX, u + b * NU, J64);
          for (int i = 0; i < NX; ++i) xf[i] = (float)x[b * NX + i];
          for (int r = 0; r < NU; ++r) uf[r] = (float)u[b * NU + r];
          env.jac(xf, uf, J32);
          for (int i = 0; i < NX; ++i)
            for (int j = 0; j < N; ++j) {
              D64[(b * NX + i) * N + j] = J64[i][j];
              D32[(b * NX + i) * N + j] = J32[i][j];
            }
        }
        return Env::NP;
      }
    }
    return -1;
  });
}
extern "C" int mlp_step_ops(int which, const float* w, const float* x, const float* u,
                            long* out) {
  return mlp_dispatch(which, [&](auto env) {
    using Env = decltype(env);
    if constexpr (is_mlp<Env>) {
      count_ops<Env, false>(w, x, u, out);
      return 0;
    } else {
      return 1;
    }
  });
}
extern "C" int riccati_plan_host(int nx, int block, int force_global, int* out) {
  return riccati_plan(nx, block, force_global, out);
}
// the kernel's C interface, run on the host; returns the lanes a team
extern "C" int riccati_host(int nx, int mode, int T, int B, int block, int force_global,
                            const float* C, long long sCt, long long sCb,
                            const float* c, long long sct, long long scb,
                            const float* F, long long sFt, long long sFb,
                            const float* u, long long sut, long long sub,
                            const float* lo, long long slt, long long slb, float lo_v,
                            const float* hi, long long sht, long long shb, float hi_v, float du,
                            const unsigned char* uz, long long szt, long long szb,
                            float* K, float* k) {
  int p[6];
  if (riccati_plan(nx, block, force_global, p)) return -1;
  std::vector<float> scratch(p[3] ? (size_t)((B + p[1] - 1) / p[1] * p[1]) * p[4] : 0);
  const RiccatiArgs a{T,  B,   nx,   C,   sCt, sCb, c,  sct, scb, F,  sFt,
                      sFb, u,  sut,  sub, lo,  slt, slb, lo_v, hi, sht, shb,
                      hi_v, du, uz,  szt, szb, K,   k,  p[3] ? scratch.data() : nullptr};
  return riccati_dispatch(nx, [&](auto s) {
    constexpr int L = decltype(s)::L, NXC = decltype(s)::NXC;
    if (mode == kModeFree) ric_run<L, NXC, kModeFree>(a, p);
    else if (mode == kModeBox) ric_run<L, NXC, kModeBox>(a, p);
    else ric_run<L, NXC, kModeZero>(a, p);
    return p[0];
  });
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the device header for the host")
    d = tmp_path_factory.mktemp("csrc")
    src, out = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(out), str(src)], check=True, capture_output=True, timeout=180)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.env_eval.argtypes = [I, P, P, P, I, P, P]
    lib.env_eval.restype = None
    lib.objective6.argtypes = [P, P, P]
    lib.objective6.restype = ctypes.c_float
    lib.kkt_host.argtypes = [I, I, I, I, I] + [P] * 9
    lib.kkt_host.restype = I
    lib.qp_eval.argtypes = [I, I] + [P] * 5 + [I] + [P] * 5
    lib.qp_eval.restype = I
    L = ctypes.c_longlong
    F32 = ctypes.c_float
    lib.riccati_host.argtypes = ([I] * 6 + [P, L, L] * 4 + [P, L, L, F32] * 2
                                 + [F32, P, L, L, P, P])
    lib.riccati_host.restype = I
    lib.riccati_plan_host.argtypes = [I, I, I, P]
    lib.riccati_plan_host.restype = I
    lib.cos_sin_eval.argtypes = [I, P, P, P]
    lib.cos_sin_eval.restype = None
    lib.box_layout.argtypes = [I, P]
    lib.box_layout.restype = None
    lib.box_step_host.argtypes = ([I, I, I] + [P] * 4 + [I, P, P, I, F32, P, P, I]
                                  + [P] * 7)
    lib.box_step_host.restype = None
    lib.inv_eval.argtypes = [I, I, P, P]
    lib.inv_eval.restype = I
    lib.lindx_eval.argtypes = [I, I, I, I] + [P] * 6
    lib.lindx_eval.restype = I
    lib.lindx_box_step.argtypes = [I, I, I, I] + [P] * 7 + [I] + [P] * 7
    lib.lindx_box_step.restype = I
    lib.jvp_eval.argtypes = [I, I, P, P, P, I, P, P]
    lib.jvp_eval.restype = I
    lib.legacy_step.argtypes = [I, P, P, P, I, P]
    lib.legacy_step.restype = I
    lib.step_ops.argtypes = [I, I, P, P, P, P]
    lib.step_ops.restype = I
    lib.mlp_eval.argtypes = [I, P, P, P, I, P, P, P, P]
    lib.mlp_eval.restype = I
    lib.mlp_layout.argtypes = [I, P]
    lib.mlp_layout.restype = I
    lib.mlp_step_ops.argtypes = [I, P, P, P, P]
    lib.mlp_step_ops.restype = I
    lib.mlp_hand_jac.argtypes = [I, I, P, P, P, I, P, P]
    lib.mlp_hand_jac.restype = I
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("mod", [cartpole, pendulum], ids=["cartpole", "pendulum"])
def test_device_env_code_matches_kernel_forms(lib, mod):
    dyn = mod.make()
    nx = dyn.n_state
    rng = np.random.RandomState(0)
    B = 64
    th = rng.uniform(-np.pi, np.pi, B)
    scale = 1.0 + 0.3 * rng.randn(B)
    cs = np.stack([np.cos(th) * scale, np.sin(th) * scale], 1)
    x = (np.concatenate([rng.randn(B, 2), cs, rng.randn(B, 1)], 1) if nx == 5
         else np.concatenate([cs, rng.randn(B, 1)], 1)).astype(np.float32)
    bound = dyn.upper
    u = (1.5 * bound * rng.uniform(-1, 1, (B, 1))).astype(np.float32)  # inside and past the box
    # example 0 has the degenerate angle (0, 0): rotate_cs's zero-norm guard
    x[0, slice(2, 4) if nx == 5 else slice(0, 2)] = 0.0
    params = mod.default_params().numpy()
    xn = np.zeros((B, nx), np.float32)
    D = np.zeros((B, nx, nx + 1), np.float32)
    lib.env_eval(dyn.device_env, _ptr(params), _ptr(x), _ptr(u), B, _ptr(xn), _ptr(D))

    tx, tu, tp = torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(params)
    np.testing.assert_allclose(xn, dyn.kernel_step(tx, tu, tp).numpy(), atol=2e-6, rtol=0)
    # the Jacobian at the degenerate point is 1/sqrt(1e-30)-sized: compare
    # the others
    np.testing.assert_allclose(D[1:], dyn.jac_lanes(tx, tu, tp).numpy()[1:], atol=2e-6,
                               rtol=2e-6)


def test_device_rocket_code_matches_kernel_forms(lib):
    """Rocket::step (thrust inside and past the +-400 clamp) and
    Rocket::jac against the port's step and jac_lanes, on states with an
    un-normalized quaternion and non-default params."""
    dyn = rocket.make()
    rng = np.random.RandomState(2)
    B = 64
    x = rng.randn(B, 13).astype(np.float32)
    u = (300.0 * rng.randn(B, 3)).astype(np.float32)
    params = np.array([0.5, 1.2, 0.8, 1.3, 0.9], np.float32)
    xn = np.zeros((B, 13), np.float32)
    D = np.zeros((B, 13, 16), np.float32)
    lib.env_eval(dyn.device_env, _ptr(params), _ptr(x), _ptr(u), B, _ptr(xn), _ptr(D))
    tx, tu, tp = torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(params)
    want = dyn.kernel_step(tx, tu, tp).numpy()
    np.testing.assert_allclose(xn, want, atol=2e-6 * np.abs(want).max(), rtol=0)
    want = dyn.jac_lanes(tx, tu, tp).numpy()
    np.testing.assert_allclose(D, want, atol=2e-6 * np.abs(want).max(), rtol=0)


def test_device_cos_sin_is_within_an_ulp(lib):
    """cos_sin, the env code's (cos, sin), against numpy's float64 cos/sin
    rounded to f32: within one ulp everywhere (the double evaluation rounds
    once, so nearly always the same float), on the angles the envs meet,
    near multiples of pi/2, out to 1e5; NaN for NaN and +-inf."""
    rng = np.random.RandomState(3)
    k = np.arange(-64, 65)
    x = np.concatenate([rng.uniform(-4, 4, 20000), rng.uniform(-1e5, 1e5, 5000),
                        k * np.pi / 2, k * np.pi / 2 + 1e-6, k * np.pi / 4,
                        [0.0, -0.0, 1e-30, 1e-8, 1e5]]).astype(np.float32)
    c = np.zeros_like(x)
    s = np.zeros_like(x)
    lib.cos_sin_eval(len(x), _ptr(x), _ptr(c), _ptr(s))
    for got, fn in ((c, np.cos), (s, np.sin)):
        want = fn(x.astype(np.float64))
        ulp = np.spacing(np.abs(want).astype(np.float32))
        err = np.abs(got.astype(np.float64) - want)
        assert (err <= ulp).all(), (err / ulp).max()
        assert (got == want.astype(np.float32)).mean() > 0.999
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    c, s = np.zeros(3, np.float32), np.zeros(3, np.float32)
    lib.cos_sin_eval(3, _ptr(bad), _ptr(c), _ptr(s))
    assert np.isnan(c).all() and np.isnan(s).all()


def _qp_problem(m, B, seed):
    """Box-QPs with a random SPD Hessian, half the optima outside the box."""
    rng = np.random.RandomState(seed)
    A = rng.randn(B, m, m)
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(m)).astype(np.float32)
    q = (2.0 * rng.randn(B, m)).astype(np.float32)
    lb = -rng.uniform(0.1, 1.0, (B, m)).astype(np.float32)
    ub = rng.uniform(0.1, 1.0, (B, m)).astype(np.float32)
    x0 = rng.randn(B, m).astype(np.float32)
    return H, q, lb, ub, x0


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("n_iter", [0, 20])
def test_device_box_qp_matches_plain_version(lib, m, n_iter):
    """pnqp (the kernel's box-QP, per example) against the plain version's
    _pnqp_tiles at one example a tile: n_iter=0 holds the Newton step's
    active set and masked Hessian at the clipped start, n_iter=20 the whole
    Newton/Armijo loop; also inv_small and qp_obj against PyTorch."""
    B = 64
    H, q, lb, ub, x0 = _qp_problem(m, B, 10 * m + n_iter)
    outs = [np.zeros(s, np.float32) for s in ((B, m), (B, m), (B, m, m), (B, m, m), (B,))]
    rc = lib.qp_eval(m, B, *[_ptr(a) for a in (H, q, lb, ub, x0)], n_iter,
                     *[_ptr(a) for a in outs])
    assert rc == 0
    x, If, Hf, Hinv, obj = outs
    t = [torch.from_numpy(a) for a in (H, q, lb, ub, x0)]
    wx, wIf, wHf = ilqr_fused._pnqp_tiles(*t, n_iter, 1)
    if n_iter:
        assert (np.abs(x - ub) < 1e-6).any() or (np.abs(x - lb) < 1e-6).any()
    np.testing.assert_array_equal(If, wIf.numpy())
    np.testing.assert_allclose(x, wx.numpy(), atol=1e-5 * max(1.0, np.abs(x).max()), rtol=0)
    np.testing.assert_allclose(Hf, wHf.numpy(), rtol=1e-6, atol=0)
    wHinv = inv_small(t[0]).numpy()
    np.testing.assert_allclose(Hinv, wHinv, rtol=0, atol=1e-5 * np.abs(wHinv).max())
    tH, tq, tx0 = t[0], t[1], t[4]
    wobj = (0.5 * (tx0 * (tH @ tx0[..., None])[..., 0]).sum(-1) + (tq * tx0).sum(-1)).numpy()
    np.testing.assert_allclose(obj, wobj, rtol=1e-5, atol=1e-6)


def test_device_objective_matches_torch(lib):
    rng = np.random.RandomState(1)
    A = rng.randn(6, 6)
    C = (A @ A.T).astype(np.float32)
    c = rng.randn(6).astype(np.float32)
    tau = rng.randn(6).astype(np.float32)
    C_flat = np.ascontiguousarray(C.reshape(-1))
    got = lib.objective6(_ptr(tau), _ptr(C_flat), _ptr(c))
    t = torch.from_numpy(tau)
    want = 0.5 * t @ torch.from_numpy(C) @ t + torch.from_numpy(c) @ t
    assert abs(got - float(want)) <= 2e-6 * max(1.0, abs(float(want)))


@pytest.mark.parametrize("nx,nu", [(3, 1), (4, 1), (5, 1), (4, 2), (4, 3), (13, 3), (6, 1),
                                   (14, 3), (16, 1)])
def test_device_kkt_code_matches_plain_version(lib, nx, nu):
    """kkt_example, the code each lane team of the CUDA kernel runs, built
    for the host (the team's lanes run each phase in turn) against
    kkt_fused_reference on the same operands, in full mode: all five
    outputs, half the controls frozen at random; team sizes 4 to 32 (L >=
    n_state + n_ctrl). K, k and dtau in the team's memory and in the global
    store give the same bits."""
    T, B, n = 7, 6, nx + nu
    rng = np.random.RandomState(nx * 10 + nu)
    A = rng.randn(T, B, n, n)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    C = f32(A @ A.transpose(0, 1, 3, 2) + 2.0 * np.eye(n))
    ops = kkt_fused.prepare(nx, nu, C, f32(rng.randn(T, B, n)),
                            f32(0.3 * rng.randn(T - 1, B, nx, n)), f32(rng.randn(T, B, nx)),
                            f32(rng.randn(T, B, nu)),
                            torch.from_numpy(rng.rand(T, B, nu) < 0.5))
    gx, gu = f32(rng.randn(T, B, nx)), f32(rng.randn(T, B, nu))
    want = kkt_fused.kkt_fused_reference(ops, gx, gu, True)
    slab = np.ascontiguousarray(ops.slab.numpy())
    outs = {}
    for global_store in (0, 1):
        got = [np.zeros(s, np.float32) for s in ((B, nx), (T, B, n, n), (T, B, n),
                                                  (T - 1, B, nx, n), (T - 1, B, nx))]
        store = np.zeros(T * B * (nu * nx + nu + 32), np.float32)
        L = lib.kkt_host(nx, nu, T, B, global_store, _ptr(slab), _ptr(gx.numpy()), _ptr(gu.numpy()),
                         *[_ptr(a) for a in got[3:] + got[:3]], _ptr(store))
        assert L == max(4, 1 << (n - 1).bit_length())
        outs[global_store] = got
    for name, a, b, w in zip(("dx_init", "dC", "dc", "dF", "df"), outs[0], outs[1], want):
        w = w.numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def _riccati_host(lib, nx, T, B, C, c, F, u, kw, block=128, force_global=0):
    """riccati_host (the kernel's C interface run on the host) on torch CPU
    tensors; returns (lanes a team, K [T,B,nx], k [T,B])."""
    mode = "box" if "u_lower" in kw else "zero" if "u_zero_I" in kw else "free"

    def bound(v):
        if isinstance(v, float):
            return None, 0, 0, v
        v = v.expand(T, B, 1)
        return v.data_ptr(), v.stride(0), v.stride(1), 0.0

    lo, hi = (bound(kw[k]) if k in kw else (None, 0, 0, 0.0) for k in ("u_lower", "u_upper"))
    mask = kw["u_zero_I"].expand(T, B, 1) if "u_zero_I" in kw else None
    K = np.zeros((T, B, nx), np.float32)
    k = np.zeros((T, B), np.float32)
    L = lib.riccati_host(nx, riccati_fused.MODES[mode], T, B, block, force_global,
                         C.data_ptr(), C.stride(0), C.stride(1),
                         c.data_ptr(), c.stride(0), c.stride(1),
                         F.data_ptr(), F.stride(0), F.stride(1),
                         u.data_ptr(), u.stride(0), u.stride(1), *lo, *hi,
                         float(kw.get("delta_u", math.inf)),
                         None if mask is None else mask.data_ptr(),
                         0 if mask is None else mask.stride(0),
                         0 if mask is None else mask.stride(1), _ptr(K), _ptr(k))
    return L, K, k


@pytest.mark.parametrize("mode", list(riccati_fused.MODES))
@pytest.mark.parametrize("nx", list(range(1, 9)) + [9, 16, 31, 40])
def test_device_riccati_code_matches_plain_version(lib, nx, mode):
    """The code each lane team of the CUDA kernel runs (riccati_team; past
    n_state 31 the looped form, riccati_looped), built for the host with its
    lanes run phase by phase, against riccati_fused_reference: n_state 1..8
    and 9, 16, 31 and 40 (looped) in every mode, a tight box (about half the
    gains at a bound) and a random mask; odd n_state read C expanded from
    one [n, n] matrix (T and B strides 0), as an example-invariant cost
    reaches the kernel. From n_state 9 on the box mode takes a [T, B, 1]
    lower bound and delta_u, folded in the kernel; a ragged batch of 7
    examples leaves part of a block's teams idle. Other block sizes, and the
    looped form's device-memory store, give the same bits."""
    T, B, n = 9, 7, nx + 1
    rng = np.random.RandomState(100 * nx + riccati_fused.MODES[mode])
    A = rng.randn(T, B, n, n)
    C = torch.from_numpy((A @ A.transpose(0, 1, 3, 2) + 2.0 * np.eye(n)).astype(np.float32))
    if nx % 2:
        C = C[0, 0].expand(T, B, n, n)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    c = f32(rng.randn(T, B, n))
    F = f32((0.3 / max(1.0, (nx / 8) ** 0.5)) * rng.randn(T - 1, B, nx, n))
    u = f32(rng.randn(T, B, 1))
    kw = {"free": {}, "box": dict(u_lower=-0.3, u_upper=0.3),
          "zero": dict(u_zero_I=torch.from_numpy(rng.rand(T, B, 1) < 0.5))}[mode]
    if mode == "box" and nx >= 9:
        kw = dict(u_lower=f32(-0.3 - 0.1 * rng.rand(T, B, 1)), u_upper=0.3, delta_u=1.0)
    want_K, want_k = riccati_fused.riccati_fused_reference(nx, C, c, F, u, **kw)
    L, K, k = _riccati_host(lib, nx, T, B, C, c, F, u, kw)
    assert L == (32 if nx + 1 > 32 else max(4, 1 << nx.bit_length()))
    for got, w in ((K, want_K[:, :, 0]), (k, want_k[..., 0])):
        w = w.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))
    if mode == "box":
        _, lb, ub = riccati_fused._operands(C, u, kw["u_lower"], kw["u_upper"], None,
                                            kw.get("delta_u"))
        at = (np.abs(k - lb.numpy()) < 1e-6) | (np.abs(k - ub.numpy()) < 1e-6)
        assert 0.1 < at.mean() < 0.9
    for block, glob in ((64, 0), (256, 0)) + (((128, 1),) if nx + 1 > 32 else ()):
        _, K2, k2 = _riccati_host(lib, nx, T, B, C, c, F, u, kw, block, glob)
        np.testing.assert_array_equal(K2, K)
        np.testing.assert_array_equal(k2, k)


def test_riccati_plan(lib):
    """The launch plan (riccati_plan, what the card's wrapper reads): the
    team's lanes, its teams a block, where the looped form's team memory
    lives, and the block sizes and stores each form refuses."""
    def plan(nx, block=128, glob=0):
        out = (ctypes.c_int * 6)()
        rc = lib.riccati_plan_host(nx, block, glob, out)
        return None if rc else dict(zip(("L", "teams", "smem", "global", "team", "looped"), out))

    for nx, L in ((1, 4), (3, 4), (5, 8), (6, 8), (7, 8), (15, 16), (16, 32), (31, 32)):
        p = plan(nx)
        assert (p["L"], p["teams"], p["global"], p["looped"]) == (L, 128 // L, 0, 0)
        assert p["smem"] <= 232448 and p["team"] % 8 == 4
        assert plan(nx, 256)["smem"] <= 232448
        assert plan(nx, 128, 1) is None  # the team form keeps nothing in device memory
    p = plan(48)
    assert (p["L"], p["teams"], p["global"], p["looped"]) == (32, 4, 0, 1)
    assert 0 < p["smem"] <= 232448 // 2
    p = plan(64)
    assert (p["global"], p["smem"], p["looped"]) == (1, 0, 1)
    assert plan(64, 64)["global"] == 0  # two teams fit
    assert plan(48, 128, 1)["global"] == 1
    assert plan(5, 96) is not None and plan(5, 100) is None and plan(0) is None


SEED = 11


def _box_step(lib, dyn, rng, x, u, last, lo, hi, lanes=False, du=None, Iz=None):
    """riccati_box_step of ``dyn`` (the rocket or its slew-rate wrapper) on
    the host and the plain version's step (ilqr_fused._q_terms and
    riccati_step, each example its own tile) on the same f32 inputs: the
    states x [B, nx] and controls u [B, nu], a random SPD cost-to-go (zero
    at the last step), the rocket's cost (the wrapper's u_{t-1} weighted 1;
    per example, scaled in [1, 1.5], with ``lanes``), bounds lo/hi ([nu] or
    [B, nu]), delta_u ``du`` and an unboxed solve's mask Iz [B, nu].
    Returns (got, want, k, votes)."""
    nx, nu = dyn.n_state, dyn.n_ctrl
    n, B = nx + nu, x.shape[0]
    tau = np.ascontiguousarray(np.concatenate([x, u], 1), np.float32)
    u = tau[:, nx:]
    lo = np.array(np.broadcast_to(lo, (B, nu)), np.float32, order="C")
    hi = np.array(np.broadcast_to(hi, (B, nu)), np.float32, order="C")
    q, p = (a.numpy() for a in rocket.get_true_obj())
    q, p = np.concatenate([np.ones(n - 16), q]), np.concatenate([np.zeros(n - 16), p])
    C = np.diag(q).astype(np.float32)
    c = p.astype(np.float32)
    if lanes:
        w = rng.uniform(1.0, 1.5, B).astype(np.float32)
        C = C[None] * w[:, None, None]
        c = c[None] * w[:, None]
    params = rocket.default_params().numpy()
    if last:
        V = np.zeros((B, nx, nx), np.float32)
        v = np.zeros((B, nx), np.float32)
    else:
        A = rng.randn(B, nx, nx)
        V = (A @ A.transpose(0, 2, 1) + np.eye(nx)).astype(np.float32)
        v = (3.0 * rng.randn(B, nx)).astype(np.float32)
    warm = np.clip(0.3 * rng.randn(B, nu), lo - u, hi - u).astype(np.float32)

    layout = np.zeros(6, np.int32)
    lib.box_layout(dyn.device_env, _ptr(layout))
    kV, kQ, kF, kFloats, split, _ = (int(a) for a in layout)
    iu = np.triu_indices(nx)
    store = np.zeros((kFloats, B), np.float32)
    store[kV:kV + len(iu[0])] = V[:, iu[0], iu[1]].T
    fscratch = np.zeros(((nx + 1) * n, B), np.float32)
    quu = np.zeros((nu * nu, B), np.float32)
    v_dev = v.copy()
    K = np.zeros((B, nu, nx), np.float32)
    k = np.zeros((B, nu), np.float32)
    votes = np.zeros(B, np.int32)
    C_in = np.ascontiguousarray(C.reshape(B, n * n).T if lanes else C)
    c_in = np.ascontiguousarray(c.T if lanes else c)
    Iz_in = None if Iz is None else np.ascontiguousarray(Iz, np.float32)
    lib.box_step_host(dyn.device_env, B, int(last), _ptr(params), _ptr(tau), _ptr(C_in),
                      _ptr(c_in), int(lanes), _ptr(lo), _ptr(hi), int(du is not None),
                      0.0 if du is None else du, None if Iz_in is None else _ptr(Iz_in),
                      _ptr(warm), 20, _ptr(store), _ptr(fscratch), _ptr(quu), _ptr(v_dev),
                      _ptr(K), _ptr(k), _ptr(votes))

    t = {name: torch.from_numpy(a) for name, a in
         (("tau", tau), ("C", C), ("c", c), ("V", V), ("v", v), ("warm", warm))}
    tx, tu = t["tau"][:, :nx], t["tau"][:, nx:]
    F = (torch.zeros(B, nx, n) if last
         else dyn.jac_lanes(tx, tu, torch.from_numpy(params)))
    Q, qv = ilqr_fused._q_terms(t["C"], t["c"], t["tau"], F, t["V"], t["v"])
    wK, wk, wV, wv = ilqr_fused.riccati_step(
        Q, qv, nx, tu, torch.from_numpy(lo), torch.from_numpy(hi), None if last else t["warm"],
        20, 1, du=du, Iz=None if Iz is None else torch.from_numpy(Iz_in))
    # the triangle's entries the store holds: all, or in the split layout
    # those before Quu (the box-QP's H, in registers, seen through quu)
    iq = tuple(a[:kFloats - kQ - (0 if split else nx * n)] for a in np.triu_indices(n))
    Fg = fscratch[:nx * n] if split else store[kF:kF + nx * n]
    got = {"F": Fg.T.reshape(B, nx, n),
           "Q": store[kQ:kQ + len(iq[0])].T, "Quu": quu.T.reshape(B, nu, nu), "K": K, "k": k,
           "V": store[kV:kV + len(iu[0])].T, "v": v_dev}
    want = {"F": F.numpy(), "Q": Q.numpy()[:, iq[0], iq[1]], "Quu": Q.numpy()[:, nx:, nx:],
            "K": wK.numpy(), "k": wk.numpy(), "V": wV.numpy()[:, iu[0], iu[1]],
            "v": wv.numpy()}
    return got, want, k, votes


def _assert_step(got, want):
    for name in got:
        w = want[name]
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def _rocket_point(rng, B):
    """Bench-like rocket states and controls near hover."""
    x = bench_start(B, 5)
    u = np.stack([10.0 + rng.randn(B), 0.05 * rng.randn(B), 0.05 * rng.randn(B)], 1)
    return x, u


@pytest.mark.parametrize("last", [False, True], ids=["step", "last"])
@pytest.mark.parametrize("bounds", ["box", "tight"])
def test_device_rocket_riccati_step_matches_plain_version(lib, bounds, last):
    """riccati_box_step, the rocket's Riccati step as the CUDA kernel runs
    it over [entry][example] storage (V and Q as triangles, F dense, Q
    formed four columns of V F at a time), against the plain version's step
    (ilqr_fused._q_terms and riccati_step, each example its own tile) at f32:
    the Jacobian at bench-like states, a random SPD cost-to-go, the +-20
    box and the tight +-(8, 0.1, 0.1), a step with its k_{t+1} warm start
    and the last step (V = 0, F = 0, the ridged Newton warm start).
    Tolerance 1e-4 relative to each output's largest entry: the two sum in
    other orders, and the box-QP's Newton and Armijo steps and the gains'
    inverse of H_free carry that rounding along. The seed is one without a
    rounding fork at the box-QP's 1e-4 Newton exit: at seed 7 (tight, step)
    one example of 48 stops a Newton step apart in the two versions, its k
    2.6e-3 off while the other 47 agree to 6e-8 (measured)."""
    B = 48
    rng = np.random.RandomState(SEED + 2 * last + (bounds == "tight"))
    x, u = _rocket_point(rng, B)
    hi = np.array([20.0, 20.0, 20.0] if bounds == "box" else [8.0, 0.1, 0.1], np.float32)
    got, want, k, votes = _box_step(lib, rocket.make(), rng, x, u, last, -hi, hi)
    _assert_step(got, want)
    # the Newton loop ran (one vote at least a step) and, with the tight
    # bounds, controls end at a bound
    assert votes.min() >= 1
    if bounds == "tight" and not last:
        u = u.astype(np.float32)
        at = (np.abs(k - (-hi - u)) < 1e-6) | (np.abs(k - (hi - u)) < 1e-6)
        assert at.mean() > 0.1, at.mean()


@pytest.mark.parametrize("last", [False, True], ids=["step", "last"])
@pytest.mark.parametrize("variant", ["lanes_cost", "dyn_bounds", "delta_u", "zero"])
@pytest.mark.parametrize("slew", [False, True], ids=["rocket", "rocket_slew"])
def test_device_riccati_step_variants_match_plain_version(lib, slew, variant, last):
    """riccati_box_step's MPC variants against the plain version's step,
    for the rocket and its slew-rate wrapper Passthrough<Rocket> (16
    states, the u_{t-1} rows of F constant): a per-example cost, per-example
    bounds that bind (0.1-0.3 on the side thrusts), delta_u = 0.05 beside
    the +-20 box, and the free subspace of an unboxed solve with about 35%
    of the controls masked (no box-QP, so no vote). Tolerance as
    test_device_rocket_riccati_step_matches_plain_version."""
    dyn = rocket.make()
    if slew:
        dyn = ctrl_passthrough.make(dyn)
    B = 48
    rng = np.random.RandomState(SEED + 11 + 2 * last + 4 * slew)
    x, u = _rocket_point(rng, B)
    if slew:
        x = np.concatenate([u + 0.1 * rng.randn(B, 3), x], 1)
    hi = np.array([20.0, 20.0, 20.0], np.float32)
    kw = {}
    if variant == "lanes_cost":
        kw["lanes"] = True
    elif variant == "dyn_bounds":
        hi = np.stack([rng.uniform(9.0, 12.0, B), rng.uniform(0.1, 0.3, B),
                       rng.uniform(0.1, 0.3, B)], 1).astype(np.float32)
    elif variant == "delta_u":
        kw["du"] = 0.05
    else:
        kw["Iz"] = (rng.rand(B, 3) < 0.35).astype(np.float32)
    got, want, k, votes = _box_step(lib, dyn, rng, x, u, last, -hi, hi, **kw)
    _assert_step(got, want)
    if variant == "zero":
        assert (k[kw["Iz"] == 1.0] == 0.0).all() and votes.max() == 0
    else:
        assert votes.min() >= 1
    if variant == "delta_u":
        assert np.abs(k).max() <= 0.05 and (np.abs(np.abs(k) - 0.05) < 1e-6).mean() > 0.1
    if variant == "dyn_bounds" and not last:
        uu = u.astype(np.float32)
        at = (np.abs(k - (-hi - uu)) < 1e-6) | (np.abs(k - (hi - uu)) < 1e-6)
        assert at.mean() > 0.1, at.mean()


@pytest.mark.parametrize("mod", [cartpole, pendulum, rocket], ids=["cartpole", "pendulum", "rocket"])
def test_device_passthrough_code_matches_kernel_forms(lib, mod):
    """Passthrough<Env> (the slew-rate state (u_{t-1}, x)): its step and
    Jacobian against the port's ctrl_passthrough wrapper (kernel_step,
    jac_lanes) on the same f32 inputs, at test_device_env_code's
    tolerances; and the wrapper's jac_lanes at f64 against
    torch.func.jacfwd of its un-clamped step."""
    base = mod.make()
    dyn = ctrl_passthrough.make(base)
    nxb, nu = base.n_state, base.n_ctrl
    rng = np.random.RandomState(4)
    B = 32
    if mod is rocket:
        xb = rng.randn(B, 13)
        u = 300.0 * rng.randn(B, 3)
    else:
        th = rng.uniform(-np.pi, np.pi, B)
        cs = np.stack([np.cos(th), np.sin(th)], 1)
        xb = (np.concatenate([rng.randn(B, 2), cs, rng.randn(B, 1)], 1) if nxb == 5
              else np.concatenate([cs, rng.randn(B, 1)], 1))
        u = 1.5 * base.upper * rng.uniform(-1, 1, (B, 1))
    x = np.concatenate([rng.randn(B, nu), xb], 1).astype(np.float32)
    u = u.astype(np.float32)
    params = mod.default_params().numpy()
    nx = nu + nxb
    xn = np.zeros((B, nx), np.float32)
    D = np.zeros((B, nx, nx + nu), np.float32)
    lib.env_eval(dyn.device_env, _ptr(params), _ptr(x), _ptr(u), B, _ptr(xn), _ptr(D))
    tx, tu, tp = torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(params)
    want = dyn.kernel_step(tx, tu, tp).numpy()
    np.testing.assert_allclose(xn, want, atol=2e-6 * max(1.0, np.abs(want).max()), rtol=0)
    want = dyn.jac_lanes(tx, tu, tp).numpy()
    np.testing.assert_allclose(D, want, atol=2e-6 * max(1.0, np.abs(want).max()), rtol=0)
    assert (D[:, :nu, :nx] == 0).all() and (D[:, nu:, :nu] == 0).all()
    assert (D[:, :nu, nx:] == np.eye(nu)).all()
    # the wrapper's Jacobian is the derivative of its step, at f64
    tx, tu, tp = tx.double(), tu.double(), tp.double()
    got = dyn.jac_lanes(tx, tu, tp)
    for i in range(4):
        J = jacfwd(lambda xu: dyn.step_unclamped(xu[:nx], xu[nx:], tp))(
            torch.cat([tx[i], tu[i]]))
        np.testing.assert_allclose(J.numpy(), got[i].numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("m", [4, 5, 6, 7, 8])
def test_device_gauss_jordan_inverse_matches_inv_lanes(lib, m):
    """inv_small<M> for M = 4..8 (the kernel's unpivoted Gauss-Jordan) on
    SPD-plus-ridge matrices: bit for bit the plain version's inv_lanes (the
    same operations in the same order, no FMA in either here), and within
    1e-4 of torch.linalg.inv relative to the largest entry (f32 elimination
    against an f64 LU)."""
    B = 32
    rng = np.random.RandomState(40 + m)
    A = rng.randn(B, m, m)
    H = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(m)).astype(np.float32)
    R = np.zeros_like(H)
    assert lib.inv_eval(m, B, _ptr(H), _ptr(R)) == 0
    np.testing.assert_array_equal(R, ilqr_fused.inv_lanes(torch.from_numpy(H)).numpy())
    want = torch.linalg.inv(torch.from_numpy(H).double()).numpy()
    np.testing.assert_allclose(R, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("nx,nu,with_f", [(1, 1, True), (3, 2, True), (3, 2, False), (5, 2, True),
                                          (9, 1, False), (4, 5, True), (4, 8, True)])
def test_device_lindx_code_matches_affine_step(lib, nx, nu, with_f):
    """LinDx<NX, NU>, the kernel's env of a time-varying affine problem:
    at step t of F [T-1, NX*N, B] and f [T-1, NX, B] its step is F_t tau +
    f_t and its Jacobian F_t, each example reading its own column. The step
    within 1e-6 of the plain version's (its sum in order, PyTorch's in
    another), the Jacobian exactly."""
    B, T, t = 16, 4, 2
    n = nx + nu
    rng = np.random.RandomState(nx * 10 + nu)
    F = rng.randn(T - 1, B, nx, n).astype(np.float32)
    f = rng.randn(T - 1, B, nx).astype(np.float32) if with_f else None
    x = rng.randn(B, nx).astype(np.float32)
    u = rng.randn(B, nu).astype(np.float32)
    Fl = np.ascontiguousarray(F.reshape(T - 1, B, nx * n).transpose(0, 2, 1))
    fl = None if f is None else np.ascontiguousarray(f.transpose(0, 2, 1))
    xn = np.zeros((B, nx), np.float32)
    D = np.zeros((B, nx, n), np.float32)
    assert lib.lindx_eval(nx, nu, t, B, _ptr(Fl), None if fl is None else _ptr(fl), _ptr(x),
                          _ptr(u), _ptr(xn), _ptr(D)) == 0
    np.testing.assert_array_equal(D, F[t])
    tau = torch.from_numpy(np.concatenate([x, u], 1))
    want = (torch.from_numpy(F[t]) @ tau[:, :, None])[:, :, 0]
    if f is not None:
        want = want + torch.from_numpy(f[t])
    np.testing.assert_allclose(xn, want.numpy(), rtol=0, atol=1e-6 * max(1.0, want.abs().max()))


@pytest.mark.parametrize("last", [False, True], ids=["step", "last"])
@pytest.mark.parametrize("nx,nu", [(3, 2), (4, 5), (9, 1), (15, 2)])
def test_device_lindx_riccati_step_matches_plain_version(lib, nx, nu, last):
    """riccati_box_step on LinDx<NX, NU> (V, Q, F in strided storage, F
    read from the data; past 225 floats an example, (15, 2), the split
    layout: F and q in a scratch, Quu in registers and compared through
    the step's quu) against the plain version's
    step (_q_terms and riccati_step, each example its own tile): n_ctrl 2
    (Cramer) and 5 (Gauss-Jordan) through the per-example box-QP, n_ctrl 1
    past the register path (the closed-form 1-D QP), a step with its warm
    start and the last step (V = 0, F = 0). Bounds +-0.5 about the
    controls, which bind; tolerance as
    test_device_rocket_riccati_step_matches_plain_version."""
    B, n = 48, nx + nu
    rng = np.random.RandomState(70 + 3 * nx + nu + 100 * last)
    F = (rng.randn(1, B, nx, n) * 0.3 + np.eye(nx, n)).astype(np.float32)
    A = rng.randn(n, n)
    C = (A @ A.T + 0.5 * np.eye(n)).astype(np.float32)
    c = rng.randn(n).astype(np.float32)
    tau = rng.randn(B, n).astype(np.float32)
    u = tau[:, nx:]
    lo = np.ascontiguousarray(u - 0.5, np.float32)
    hi = np.ascontiguousarray(u + 0.5, np.float32)
    if last:
        V = np.zeros((B, nx, nx), np.float32)
        v = np.zeros((B, nx), np.float32)
    else:
        Av = rng.randn(B, nx, nx)
        V = (Av @ Av.transpose(0, 2, 1) + np.eye(nx)).astype(np.float32)
        v = (3.0 * rng.randn(B, nx)).astype(np.float32)
    warm = np.clip(0.3 * rng.randn(B, nu), -0.5, 0.5).astype(np.float32)
    layout = np.zeros(6, np.int32)
    Fl = np.ascontiguousarray(F.reshape(1, B, nx * n).transpose(0, 2, 1))
    # the layout first (a call on no example), then the step
    store = np.zeros((1, 1), np.float32)
    lib.lindx_box_step(nx, nu, 0, 1, _ptr(Fl), _ptr(tau), _ptr(C.reshape(-1)), _ptr(c),
                       _ptr(lo), _ptr(hi), _ptr(warm), 20, _ptr(store), None, None, _ptr(v),
                       None, None, _ptr(layout))
    kV, kQ, kF, kFloats, split, scratch = (int(a) for a in layout)
    assert (split, scratch) == (int(nx == 15), (nx + 1) * n if nx == 15 else 0)
    iu = np.triu_indices(nx)
    store = np.zeros((kFloats, B), np.float32)
    store[kV:kV + len(iu[0])] = V[:, iu[0], iu[1]].T
    fscratch = np.zeros(((nx + 1) * n, B), np.float32)
    quu = np.zeros((nu * nu, B), np.float32)
    v_dev = v.copy()
    K = np.zeros((B, nu, nx), np.float32)
    k = np.zeros((B, nu), np.float32)
    Cf = np.ascontiguousarray(C.reshape(-1))
    assert lib.lindx_box_step(nx, nu, B, int(last), _ptr(Fl), _ptr(tau), _ptr(Cf), _ptr(c),
                              _ptr(lo), _ptr(hi), _ptr(warm), 20, _ptr(store), _ptr(fscratch),
                              _ptr(quu), _ptr(v_dev), _ptr(K), _ptr(k), _ptr(layout)) == 0
    t = {name: torch.from_numpy(a) for name, a in
         (("tau", tau), ("C", C), ("c", c), ("V", V), ("v", v), ("warm", warm))}
    Ft = torch.zeros(B, nx, n) if last else torch.from_numpy(F[0])
    Q, qv = ilqr_fused._q_terms(t["C"], t["c"], t["tau"], Ft, t["V"], t["v"])
    wK, wk, wV, wv = ilqr_fused.riccati_step(
        Q, qv, nx, t["tau"][:, nx:], torch.from_numpy(lo), torch.from_numpy(hi),
        None if last else t["warm"], 20, 1)
    iq = tuple(a[:kFloats - kQ - (0 if split else nx * n)] for a in np.triu_indices(n))
    got = {"Q": store[kQ:kQ + len(iq[0])].T, "Quu": quu.T.reshape(B, nu, nu), "K": K, "k": k,
           "V": store[kV:kV + len(iu[0])].T, "v": v_dev}
    want = {"Q": Q.numpy()[:, iq[0], iq[1]], "Quu": Q.numpy()[:, nx:, nx:], "K": wK.numpy(),
            "k": wk.numpy(), "V": wV.numpy()[:, iu[0], iu[1]], "v": wv.numpy()}
    # F as the store or, in the split layout, the scratch holds it
    if not last:
        Fg = fscratch[:nx * n] if split else store[kF:kF + nx * n]
        got["F"] = Fg.T.reshape(B, nx, n)
        want["F"] = F[0]
    _assert_step(got, want)
    at = (np.abs(k + 0.5) < 1e-6) | (np.abs(k - 0.5) < 1e-6)
    assert at.mean() > 0.05, at.mean()


# (name, the layout's source in the test library, n_state, n_ctrl)
LAYOUT_CASES = [("rocket", ("box", 2), 13, 3), ("rocket_slew", ("box", 5), 16, 3),
                ("lindx_3_2", ("lindx", 3, 2), 3, 2), ("lindx_15_2", ("lindx", 15, 2), 15, 2),
                ("lindx_4_8", ("lindx", 4, 8), 4, 8), ("mlp_golden", ("mlp", 3), 3, 2)]


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=[c[0] for c in LAYOUT_CASES])
def test_box_layout_mirror_residency_and_waves(lib, case):
    """The strided path's layout as the C++ has it (BoxStepLayout, read
    through the test library) against its Python mirror
    (ilqr_fused.box_layout, which sizes the launch's scratch and the
    cluster sizes): the shared floats an example, whether F and Quu left
    shared memory, the floats of F's scratch. Two blocks of 128 examples
    share an SM (233,472 bytes, 1,024 reserved and 32 of vote words a
    block) exactly where the layout takes at most TWO_BLOCK_FLOATS, and
    the rocket's do: 221 floats, where V, Q and F took 435; the cluster
    sizes take G = 16 first where they cannot. And the waves
    of a launch (ilqr_fused.waves): 1, 16 and 132 tiles over 15 clusters
    at once (the rocket's occupancy with one block an SM) are 1, 2 and 9
    waves, over 30 are 1, 1 and 5."""
    name, src, nx, nu = case
    out = np.zeros(6, np.int32)
    if src[0] == "box":
        lib.box_layout(src[1], _ptr(out))
    elif src[0] == "lindx":
        assert lib.lindx_box_step(src[1], src[2], 0, 1, None, None, None, None, None, None, None,
                                  0, None, None, None, None, None, None, _ptr(out)) == 0
    else:
        assert lib.mlp_layout(src[1], _ptr(out)) == 0
    kV, kQ, kF, kFloats, split, scratch = (int(a) for a in out)
    assert (kFloats, bool(split), scratch) == tuple(ilqr_fused.box_layout(nx, nu))
    assert (kF == -1) == bool(split) and kV == 0 and kQ == nx * (nx + 1) // 2
    assert ilqr_fused.lindx_floats(nx, nu) == kFloats
    two_blocks = 2 * (4 * kFloats * 128 + 32 + 1024) <= 233472
    assert two_blocks == (kFloats <= ilqr_fused.TWO_BLOCK_FLOATS)
    if name == "rocket":
        assert kFloats == 221 and two_blocks
        assert not 2 * (4 * 435 * 128 + 32 + 1024) <= 233472
    # G = 16 first where two blocks of 128 cannot share an SM
    sizes = ilqr_fused.lindx_clusters(nx, nu)
    assert sizes == ((8, 16) if two_blocks else (16, 8))
    for occupancy, want_waves in ((15, (1, 2, 9)), (30, (1, 1, 5))):
        got = tuple(ilqr_fused.waves(ilqr_fused.geometry(B, sizes=sizes), occupancy)
                    for B in (1024, 16384, 135168))
        assert got == want_waves, (occupancy, got)


def _jvp_case(name, B, rng):
    """(port model, params, x [B, nx], u [B, nu], the control clamp) of a
    device env on random f32 states: angles of norm 0.7-1.3 off the unit
    circle, controls inside, exactly on and past the clamp (a quarter
    each on the clamp and past it)."""
    if name in ("cartpole", "pendulum", "pendulum_complex"):
        dyn = cartpole.make() if name == "cartpole" else pendulum.make(simple=name == "pendulum")
        params = (cartpole.default_params() if name == "cartpole"
                  else pendulum.default_params() if name == "pendulum"
                  else torch.tensor([10.0, 1.0, 1.0, 1.0, 0.1]))
        th = rng.uniform(-np.pi, np.pi, B)
        scale = 1.0 + 0.3 * rng.uniform(-1, 1, B)
        cs = np.stack([np.cos(th) * scale, np.sin(th) * scale], 1)
        x = (np.concatenate([rng.randn(B, 2), cs, rng.randn(B, 1)], 1) if name == "cartpole"
             else np.concatenate([cs, rng.randn(B, 1)], 1))
        lim = 100.0 if name == "cartpole" else 2.0
    else:
        dyn = rocket.make(normalize_quat=name == "rocket_norm")
        params = torch.tensor([0.5, 1.2, 0.8, 1.3, 0.9])
        x = rng.randn(B, 13)
        lim = 400.0
    nu = dyn.n_ctrl
    u = 0.8 * lim * rng.uniform(-1, 1, (B, nu))
    q = B // 4
    u[q:2 * q] = lim * np.sign(rng.randn(q, nu))
    u[2 * q:3 * q] = 1.5 * lim * np.sign(rng.randn(q, nu))
    return dyn, params.numpy(), x.astype(np.float32), u.astype(np.float32), lim


def _unclamped_kernel_step(name, dyn):
    """The un-clamped physics in kernel form, which the jvp sweep
    differentiates under ANALYTIC."""
    if name == "cartpole":
        return lambda x, u, p: cartpole._step(x, u, p, clamp_u=False, kernel=True)
    if name == "pendulum":
        return lambda x, u, p: pendulum._step(x, u, p, clamp_u=False, simple=True, kernel=True)
    return dyn.step_unclamped


@pytest.mark.parametrize("clamped", [True, False], ids=["auto_diff", "analytic"])
@pytest.mark.parametrize("name", ["cartpole", "pendulum", "rocket", "pendulum_complex",
                                  "rocket_norm"])
def test_device_jvp_jac_matches_torch_jvp(lib, name, clamped):
    """JvpJac<Env, Clamped>::jac (the jvp sweep on Duals) and the env's
    templated step against torch.func.jvp of the port's kernel-form step
    (the clamped step for AUTO_DIFF, the un-clamped physics otherwise) and
    the step itself, one one-hot tangent a column: entries within 4 ulp of
    the largest (the host build's 1/sqrtf for rsqrtf, FMA contraction and
    libm's atan2f, sin and cos against PyTorch's). Under AUTO_DIFF a
    control past the clamp has a column of exact zeros and one exactly on
    it keeps the un-clamped column (torch.clamp's convention)."""
    rng = np.random.RandomState(7)
    B = 64
    dyn, params, x, u, lim = _jvp_case(name, B, rng)
    nx, nu = dyn.n_state, dyn.n_ctrl
    xn = np.zeros((B, nx), np.float32)
    D = np.zeros((B, nx, nx + nu), np.float32)
    assert lib.jvp_eval(dyn.device_env, int(clamped), _ptr(params), _ptr(x), _ptr(u), B,
                        _ptr(xn), _ptr(D)) == 0
    tx, tu, tp = torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(params)
    want_x = dyn.kernel_step(tx, tu, tp).numpy()
    np.testing.assert_allclose(xn, want_x, atol=2e-6 * max(1.0, np.abs(want_x).max()), rtol=0)
    fn = dyn.kernel_step if clamped else _unclamped_kernel_step(name, dyn)
    want = ilqr_fused.jvp_jacobian(fn)(tx, tu, tp).numpy()
    ulp = np.finfo(np.float32).eps * np.abs(want).max()
    np.testing.assert_allclose(D, want, atol=4 * ulp, rtol=0)
    q = B // 4
    if clamped:
        assert (D[2 * q:3 * q, :, nx:] == 0).all()
        assert (np.abs(D[q:2 * q, :, nx:]).max(1) > 0).all()
    else:
        assert (np.abs(D[2 * q:3 * q, :, nx:]).max(1) > 0).all()


@pytest.mark.parametrize("name", ["pendulum_complex", "rocket_norm"])
def test_device_jvp_passthrough_matches_torch_jvp(lib, name):
    """Passthrough<JvpJac<Env, true>>: the slew-rate wrapper of the complex
    pendulum and the renormalizing rocket, its step and Jacobian against
    the port's wrapped kernel step and its jvp sweep (the passthrough rows
    exact)."""
    rng = np.random.RandomState(8)
    B = 32
    dyn, params, x, u, lim = _jvp_case(name, B, rng)
    aug = ctrl_passthrough.make(dyn)
    nx, nu = aug.n_state, aug.n_ctrl
    xa = np.concatenate([rng.uniform(-lim, lim, (B, nu)), x], 1).astype(np.float32)
    xn = np.zeros((B, nx), np.float32)
    D = np.zeros((B, nx, nx + nu), np.float32)
    assert lib.jvp_eval(aug.device_env, 1, _ptr(params), _ptr(xa), _ptr(u), B, _ptr(xn),
                        _ptr(D)) == 0
    tx, tu, tp = torch.from_numpy(xa), torch.from_numpy(u), torch.from_numpy(params)
    want_x = aug.kernel_step(tx, tu, tp).numpy()
    np.testing.assert_allclose(xn, want_x, atol=2e-6 * max(1.0, np.abs(want_x).max()), rtol=0)
    want = ilqr_fused.jvp_jacobian(aug.kernel_step)(tx, tu, tp).numpy()
    np.testing.assert_allclose(D, want, atol=4 * np.finfo(np.float32).eps * np.abs(want).max(),
                               rtol=0)
    assert (D[:, :nu, :nx] == 0).all() and (D[:, :nu, nx:] == np.eye(nu)).all()


@pytest.mark.parametrize("name", ["cartpole", "pendulum", "rocket"])
def test_templated_float_step_keeps_its_bits(lib, name):
    """step<float> of the templated envs gives the bits of the float steps
    as they were written before the templating (the same expressions,
    kept in the shim), on states and controls inside, on and past the
    clamp and the degenerate angle (0, 0)."""
    rng = np.random.RandomState(9)
    B = 256
    dyn, params, x, u, _ = _jvp_case(name, B, rng)
    if name != "rocket":
        x[0, slice(2, 4) if name == "cartpole" else slice(0, 2)] = 0.0
    nx = dyn.n_state
    got = np.zeros((B, nx), np.float32)
    D = np.zeros((B, nx, nx + dyn.n_ctrl), np.float32)
    lib.env_eval(dyn.device_env, _ptr(params), _ptr(x), _ptr(u), B, _ptr(got), _ptr(D))
    want = np.zeros((B, nx), np.float32)
    assert lib.legacy_step(dyn.device_env, _ptr(params), _ptr(x), _ptr(u), B, _ptr(want)) == 0
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("clamped", [True, False], ids=["auto_diff", "analytic"])
@pytest.mark.parametrize("name", ["cartpole", "pendulum", "rocket", "pendulum_complex",
                                  "rocket_norm"])
def test_step_operation_counts_match_the_table(lib, name, clamped):
    """ilqr_fused.STEP_OPS, the operations the jvp sweep's bound counts,
    are those of the env's templated step: the float step and the step on
    Duals counted on a host build over a counting scalar, at a point inside
    the clamp where every tangent operation runs."""
    rng = np.random.RandomState(10)
    dyn, params, x, u, lim = _jvp_case(name, 1, rng)
    u = np.full((1, dyn.n_ctrl), 0.25 * lim, np.float32)
    out = np.zeros(5, np.int64)
    assert lib.step_ops(dyn.device_env, int(clamped), _ptr(params), _ptr(x), _ptr(u),
                        _ptr(out)) == 0
    assert tuple(out) == tuple(ilqr_fused.STEP_OPS[dyn.device_env])


# the shim's Mlp instantiations (mlp_dispatch): (n_state, n_ctrl, hidden,
# activation, residual)
MLP_HOST = [(3, 1, (8,), "sigmoid", True), (3, 1, (6, 6), "relu", True),
            (3, 1, (8,), "elu", True), (3, 2, (16,), "sigmoid", True),
            (13, 3, (8,), "sigmoid", True), (3, 1, (), "elu", False),
            (4, 2, (5, 3), "relu", False)]


def _mlp_case(which, B, rng):
    """(port model, flat f32 weights, x [B, nx], u [B, nu]) of the shim's
    Mlp ``which`` at f64 points; the first half of the points is x = 0, u
    = 0 with zero hidden biases, where every hidden pre-activation is
    exactly 0."""
    nx, nu, hidden, act, res = MLP_HOST[which]
    dyn = nn_dynamics.make(nx, nu, activation=act, passthrough=res, hidden_sizes=hidden)
    ws = nn_dynamics.init_params(nx, nu, hidden,
                                 generator=torch.Generator().manual_seed(which))
    for W, b in ws[:-1]:
        b.zero_()
    flat = nn_dynamics.flat_params(ws).numpy()
    x, u = rng.randn(B, nx), rng.randn(B, nu)
    x[:B // 2], u[:B // 2] = 0.0, 0.0
    return dyn, flat, x, u


@pytest.mark.parametrize("which", range(len(MLP_HOST)),
                         ids=[f"{a}_{b}_{c}_{d}" for a, b, c, d, _ in MLP_HOST])
def test_device_mlp_code_matches_torch_jvp(lib, which):
    """Mlp<NX, NU, ACT, Residual, H...> and JvpJac<Mlp> against the port's
    kernel_step and its jvp sweep (torch.func.jvp, one one-hot column):
    the step on double and DualOf<double> against them at f64 (1e-12), the
    kernel's f32 step and JvpJac's Jacobian against the f64 ones (4e-6 of
    the largest entry, at least 1: f32 rounding over at most 17 products a
    row). Where every hidden pre-activation is exactly 0, relu'(0) = 0 and
    elu'(0) = 1: with relu the net's Jacobian is 0 there (D = [I | 0] with
    the residual), with elu it is the product of the weights."""
    rng = np.random.RandomState(20 + which)
    B = 16
    dyn, flat, x, u = _mlp_case(which, B, rng)
    nx, nu = dyn.n_state, dyn.n_ctrl
    n = nx + nu
    xn32, D32 = np.zeros((B, nx), np.float32), np.zeros((B, nx, n), np.float32)
    xn64, D64 = np.zeros((B, nx)), np.zeros((B, nx, n))
    assert lib.mlp_eval(which, _ptr(flat), _ptr(x), _ptr(u), B, _ptr(xn32), _ptr(D32),
                        _ptr(xn64), _ptr(D64)) == dyn.device_mlp.n_weights == flat.size
    tx, tu, tf = (torch.from_numpy(a) for a in (x, u, flat.astype(np.float64)))
    want_x = dyn.kernel_step(tx, tu, tf).numpy()
    want_D = ilqr_fused.jvp_jacobian(dyn.kernel_step)(tx, tu, tf).numpy()
    np.testing.assert_allclose(xn64, want_x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(D64, want_D, rtol=0, atol=1e-12)
    scale = max(1.0, np.abs(want_x).max(), np.abs(want_D).max())
    np.testing.assert_allclose(xn32, want_x, rtol=0, atol=4e-6 * scale)
    np.testing.assert_allclose(D32, want_D, rtol=0, atol=4e-6 * scale)
    act, res = MLP_HOST[which][3], MLP_HOST[which][4]
    zero = D64[:B // 2]
    if act == "relu":
        eye = np.concatenate([np.eye(nx) if res else np.zeros((nx, nx)), np.zeros((nx, nu))], 1)
        assert (zero == eye).all() and (D32[:B // 2] == eye).all()
    if act == "elu":
        ws = nn_dynamics.init_params(nx, nu, MLP_HOST[which][2],
                                     generator=torch.Generator().manual_seed(which))
        prod = np.eye(n)
        for W, _ in ws:
            prod = W.double().numpy() @ prod
        want_zero = np.broadcast_to(prod[:nx] + (np.eye(nx, n) if res else 0.0), zero.shape)
        np.testing.assert_allclose(zero, want_zero, rtol=0, atol=1e-12)


def test_device_mlp_passthrough_matches_torch_jvp(lib):
    """Passthrough<JvpJac<Mlp>>: the slew-rate wrapper of the golden's shape
    (3, 2, (16,)), its f32 step and Jacobian against the port's wrapped
    kernel step and its jvp sweep at f64 (the passthrough rows exact)."""
    rng = np.random.RandomState(30)
    B = 16
    dyn, flat, x, u = _mlp_case(3, B, rng)
    aug = ctrl_passthrough.make(dyn)
    assert aug.device_env == 11 and aug.device_mlp.slew
    nx, nu = aug.n_state, aug.n_ctrl
    xa = np.concatenate([rng.uniform(-1, 1, (B, nu)), x], 1)
    xn, D = np.zeros((B, nx), np.float32), np.zeros((B, nx, nx + nu), np.float32)
    assert lib.mlp_eval(7, _ptr(flat), _ptr(xa), _ptr(u), B, _ptr(xn), _ptr(D), None,
                        None) == flat.size
    tx, tu, tf = (torch.from_numpy(a) for a in (xa, u, flat.astype(np.float64)))
    want_x = aug.kernel_step(tx, tu, tf).numpy()
    want = ilqr_fused.jvp_jacobian(aug.kernel_step)(tx, tu, tf).numpy()
    scale = max(1.0, np.abs(want_x).max(), np.abs(want).max())
    np.testing.assert_allclose(xn, want_x, rtol=0, atol=4e-6 * scale)
    np.testing.assert_allclose(D, want, rtol=0, atol=4e-6 * scale)
    assert (D[:, :nu, :nx] == 0).all() and (D[:, :nu, nx:] == np.eye(nu)).all()


# the one-hidden-layer nets of the shim (mlp_dispatch), whose hand Jacobian
# Mlp::jac is, with the learned cartpole model (5,1,(100,)) at 8
HAND_MLP = {0: MLP_HOST[0], 2: MLP_HOST[2], 3: MLP_HOST[3], 4: MLP_HOST[4],
            8: (5, 1, (100,), "sigmoid", True)}


def _hand_case(which, B, rng):
    """_mlp_case for the shim's nets of HAND_MLP."""
    nx, nu, hidden, act, res = HAND_MLP[which]
    dyn = nn_dynamics.make(nx, nu, activation=act, passthrough=res, hidden_sizes=hidden)
    ws = nn_dynamics.init_params(nx, nu, hidden, generator=torch.Generator().manual_seed(which))
    for W, b in ws[:-1]:
        b.zero_()
    flat = torch.cat([a.reshape(-1) for layer in ws for a in layer]).numpy()
    x, u = rng.randn(B, nx), rng.randn(B, nu)
    x[:B // 2], u[:B // 2] = 0.0, 0.0
    return dyn, flat, x, u


@pytest.mark.parametrize("which", sorted(HAND_MLP),
                         ids=[f"{a}_{b}_{c}_{d}" for a, b, c, d, _ in
                              (HAND_MLP[k] for k in sorted(HAND_MLP))])
def test_device_mlp_hand_jacobian_matches_jac_lanes(lib, which):
    """Mlp::jac, the hand Jacobian of a net of one hidden layer (the
    reference's grad_input, ANALYTIC's on the card), against the port's
    jac_lanes and the jvp sweep of kernel_step at f64 (1e-12), and its f32
    build (the kernel's own code) against those (4e-6 of the largest
    entry, at least 1, with 1e-5 for hidden 100's sums of 100 products).
    Where every hidden pre-activation is exactly 0, relu'(0) = 0 and
    elu'(0) = 1, as the jvp sweep takes them."""
    rng = np.random.RandomState(50 + which)
    B = 16
    dyn, flat, x, u = _hand_case(which, B, rng)
    nx, nu = dyn.n_state, dyn.n_ctrl
    n = nx + nu
    D64, D32 = np.zeros((B, nx, n)), np.zeros((B, nx, n), np.float32)
    assert lib.mlp_hand_jac(which, 0, _ptr(flat), _ptr(x), _ptr(u), B, _ptr(D64),
                            _ptr(D32)) == flat.size == dyn.device_mlp.n_weights
    tx, tu, tf = (torch.from_numpy(a) for a in (x, u, flat.astype(np.float64)))
    want = dyn.jac_lanes(tx, tu, tf).numpy()
    np.testing.assert_allclose(D64, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        want, ilqr_fused.jvp_jacobian(dyn.kernel_step)(tx, tu, tf).numpy(), rtol=0, atol=1e-12)
    scale = max(1.0, np.abs(want).max())
    tol = 1e-5 if HAND_MLP[which][2][0] > 16 else 4e-6
    np.testing.assert_allclose(D32, want, rtol=0, atol=tol * scale)


def test_device_mlp_hand_passthrough_matches_jac_lanes(lib):
    """Passthrough<Mlp>: the slew-rate wrapper of the learned cartpole model
    with the hand Jacobian, against the wrapper's jac_lanes at f64 (f32
    build; the passthrough rows exact)."""
    rng = np.random.RandomState(60)
    B = 16
    dyn, flat, x, u = _hand_case(8, B, rng)
    aug = ctrl_passthrough.make(dyn)
    nx, nu = aug.n_state, aug.n_ctrl
    xa = np.concatenate([rng.uniform(-1, 1, (B, nu)), x], 1)
    D = np.zeros((B, nx, nx + nu), np.float32)
    assert lib.mlp_hand_jac(8, 1, _ptr(flat), _ptr(xa), _ptr(u), B, None, _ptr(D)) == flat.size
    tx, tu, tf = (torch.from_numpy(a) for a in (xa, u, flat.astype(np.float64)))
    want = aug.jac_lanes(tx, tu, tf).numpy()
    np.testing.assert_allclose(D, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    assert (D[:, :nu, :nx] == 0).all() and (D[:, :nu, nx:] == np.eye(nu)).all()


def test_device_mlp_streamed_step_matches_kernel_step(lib):
    """The learned cartpole model's step (its hidden layer streamed into the
    output, no array of it) at f64 against kernel_step (1e-12) and its f32
    build against that (1e-5 of the largest entry)."""
    rng = np.random.RandomState(61)
    B = 16
    dyn, flat, x, u = _hand_case(8, B, rng)
    n = dyn.n_state + dyn.n_ctrl
    xn32, D32 = np.zeros((B, 5), np.float32), np.zeros((B, 5, n), np.float32)
    xn64, D64 = np.zeros((B, 5)), np.zeros((B, 5, n))
    assert lib.mlp_eval(8, _ptr(flat), _ptr(x), _ptr(u), B, _ptr(xn32), _ptr(D32),
                        _ptr(xn64), _ptr(D64)) == flat.size
    tx, tu, tf = (torch.from_numpy(a) for a in (x, u, flat.astype(np.float64)))
    want = dyn.kernel_step(tx, tu, tf).numpy()
    np.testing.assert_allclose(xn64, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(D64, dyn.jac_lanes(tx, tu, tf).numpy(), rtol=0, atol=1e-12)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(xn32, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(D32, D64, rtol=0, atol=1e-5 * max(1.0, np.abs(D64).max()))


@pytest.mark.parametrize("which", range(len(MLP_HOST)),
                         ids=[f"{a}_{b}_{c}_{d}" for a, b, c, d, _ in MLP_HOST])
def test_mlp_step_operation_counts_match_the_formula(lib, which):
    """ilqr_fused.mlp_step_ops, the MLP's operations the jvp bound counts
    (chip_smoke.jvp_bound), are those of the Mlp step counted on a host
    build over the counting scalar, as a float step and on Duals, at a
    point where every hidden unit is active (positive weights and inputs),
    so that every tangent operation runs."""
    dyn, flat, x, u = _mlp_case(which, 2, np.random.RandomState(40))
    flat = np.abs(flat)
    out = np.zeros(5, np.int64)
    xf, uf = (np.ascontiguousarray(np.abs(a[-1:]) + 0.1, np.float32) for a in (x, u))
    assert lib.mlp_step_ops(which, _ptr(flat), _ptr(xf), _ptr(uf), _ptr(out)) == 0
    assert tuple(out) == tuple(ilqr_fused.mlp_step_ops(dyn.device_mlp))
