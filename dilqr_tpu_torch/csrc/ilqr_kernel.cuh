// The whole-solve batched iLQR kernel for Hopper (sm_90a), as a template
// over the env, the control count, the block size and the cost form; its
// instantiations are in ilqr_fused.cu (the envs with device code and their
// hand-derived Jacobians), ilqr_jvp.cu (an env whose Jacobian is the jvp
// sweep, JvpJac, one env and method a library), ilqr_lindx.cu (a LinDx
// problem, one shape a library) and ilqr_mlp.cu (the learned MLP with its
// widths fixed, Mlp, one shape a library), the last three built at first
// use.
//
// Replaces the Pallas TPU kernel `_ilqr_kernel` in
// dilqr_tpu/ops/pallas/ilqr_fused.py (called through `ilqr_fused`), for the
// configurations the port runs: the env's hand-derived Jacobian (the MLP's
// of one hidden layer too, whose weights are read in place), the jvp
// sweep's (JvpJac: the step on Duals once a column) or a LinDx problem's F/f
// as data
// (ilqr_fused.cuh), f32, a zero or given warm start,
// and
//  * n_ctrl == 1 (cartpole, simple pendulum, their slew-rate wrappers, a
//    LinDx problem): the closed-form 1-D box-QP;
//  * n_ctrl 2..8 (the rocket and its slew-rate wrapper: 3; LinDx: any):
//    the in-kernel projected-Newton box-QP (`_pnqp_lanes`) with its
//    explicit inverses (`_inv_lanes`: closed forms to 3, Gauss-Jordan past
//    it), warm started with k_{t+1} (at t = T-1 with the clipped ridged
//    Newton point), and gains K = -inv(H_free) (Q_ux * If) from its last
//    Newton step.
// The MPC variants are JAX's, as data: an example-invariant cost ([Tc, n*n]
// read at compile-time offsets) or a per-example one ([T, n*n, Bp], a
// template flag: the address arithmetic of the other form would cost the
// rocket its registers); static per-control bounds or per-time and
// per-example ones ([T, NU, Bp]); a u_zero_I mask (zeroed before the trial
// clamp; in an unboxed solve the Riccati's free-subspace gains instead of
// the box-QP, :1313-1334); a static delta_u (the QP bounds intersected
// with +-delta_u, the trial clamp widened around the iterate, :1307-1311,
// :1404-1408). Each is one pointer or value in Args, the same for the whole
// launch, so no warp diverges on it. The slew-rate state (u_{t-1}, x) is
// the env wrapper Passthrough<Env> (ilqr_fused.cuh), whose Jacobian is
// built from the env's.
//
// Design. One thread per example. The JAX kernel takes its decisions per
// 1024-example tile -- the line search's any(cost worsened), the
// not-improved reset's any(improved), the stopping rule's max(du) < eps,
// and inside every Riccati step the box-QP's Newton exit (no example still
// steps) and Armijo exit (max(armijo) > 0.1). Here a tile is one
// thread-block cluster of G blocks of 1024/G threads (G = 8 by default:
// 128 threads), so one tile spreads over G SMs, and each decision is a
// cluster vote (TileVote in ilqr_fused.cuh: a warp vote, the words through
// distributed shared memory, one cluster barrier; a NaN du makes both the
// any- and the all-form false, a NaN armijo ends the Armijo loop). Every
// branch around a vote is cluster-uniform: a thread whose example is done
// keeps reaching the votes, a cluster whose tile has stopped leaves the
// outer loop as a whole, and every block passes a last cluster barrier
// before it exits, so no block leaves while a peer may still read its vote
// words. Per-step arrays (reference, trial and best trajectory, gains K/k)
// live in global scratch the wrapper allocates, laid out [T, k, Bp] with
// the control axis inside k (u [T, NU, Bp], K [T, NU*NX, Bp]) so a warp's
// accesses coalesce; the three trajectory buffers change roles on accept
// instead of copying, and the best is copied out once at the end (at
// B=135168 the scratch outgrows the L2, and a copy an iteration was a fifth
// of its traffic). The cost is read through the read-only cache.
//  * n_ctrl == 1 up to kRegisterNx = 6 states: the cost-to-go V, v, Q and
//    the Jacobian F of one step are registers; a block of 128 (or 64)
//    threads lets a thread hold 255, but ptxas trades a few bytes of spill
//    for occupancy where it can, so the order in which Q is formed is
//    chosen per env (kColumnwiseQ) and x_init is re-read at each sweep: no
//    n_ctrl == 1 instantiation of the envs spills.
//  * otherwise (n_ctrl > 1, or a LinDx problem with one control and more
//    states): the rocket's V (13x13), Q (16x16) and F (13x16) would
//    not fit in registers. V and Q live in dynamic shared memory as
//    triangles, [entry][example]; F joins them, dense, where all three let
//    two blocks of 128 examples share an SM (at most kTwoBlockFloats = 225
//    floats an example: LinDx (3,2), the MLPs and traced models of few
//    states). Past that (BoxStepLayout's split layout) F, and q while Q is
//    formed, are the launch's device-memory scratch, [entry][example] a
//    block, and Q's Quu block is registers (the box-QP's H): the rocket
//    takes 221 floats (884 bytes) an example, so two blocks of 128 (G = 8; 113,152 bytes each)
//    share an SM, where V, Q and F (1,740 bytes, 222,720 a block) left
//    room for one: the card holds 30 rocket tiles at once, not 15. The slew-rate rocket (16 states) takes 1,280 bytes an example,
//    one block of 128 or two of 64 an SM; a shape past 454 floats an
//    example runs at G = 16 only (ilqr_lindx.cu). Q is formed four columns
//    of V F at a time, so each V entry is read once a column block.
//    riccati_box_step in the header is that step, built with g++ in the
//    tests.
//
// What bounds it. The work is a long sequential recursion per example
// (T steps x lqr_iter iterations x Riccati + line search) with little data:
// it is bound by operations and their latency, not by bytes. A tile now
// spans G SMs (B=4096 fills 32 of the 132 SMs at G = 8, the rocket's
// B=1024 8), but each SM holds only 1024/G threads of it: few warps to hide
// latency behind. A launch of more tiles than the card holds at once
// (cudaOccupancyMaxActiveClusters) runs in waves, each about as long as
// one. Each vote is a cluster barrier; the rocket takes several per
// Riccati step. PERF.md has the times, the vote counts and the -Xptxas -v
// report.
//
// Numerics: f32, compiled without -use_fast_math (cosf/sinf are the
// accurate versions, division and sqrt IEEE-rounded); rsqrtf and nvcc's
// default FMA contraction move results by a few ulp from the plain
// PyTorch version, which the tests' tolerances state. The result does not
// depend on G: the per-example arithmetic and the votes are the same.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "ilqr_fused.cuh"

namespace cg = cooperative_groups;

namespace dilqr {

constexpr int kTile = 1024;  // examples a tile: the JAX kernel's base tile

struct Args {
  int T, Bp;
  int Tc;               // example-invariant cost: 1 or T steps
  const float* params;  // [P]
  const float* x_init;  // [NX, Bp]
  const float* C;       // [Tc, N*N] or, per example, [T, N*N, Bp]; a callable
                        // cost's params [Cost::NP] (or null for none)
  const float* c;       // [Tc, N] or, per example, [T, N, Bp]
  const float* u_init;  // [T, NU, Bp] or null (zeros)
  float lo[kMaxNu], hi[kMaxNu];  // static per-control bounds, +-inf for none
  const float* lb;      // [T, NU, Bp] per-time and per-example bounds, or
  const float* ub;      // null: the static lo/hi
  const unsigned char* uz;  // [T, NU, Bp] the u_zero_I mask, or null
  int uz_free;          // 1: unboxed (u_lower None) with a mask: the Riccati
                        // takes the free subspace, not the box-QP
  int has_du;           // 1: the static delta_u trust region du
  float du;
  int lqr_iter, max_ls_iter, not_improved_lim, pnqp_iter;
  float eps, ls_decay, best_cost_eps;
  float* work;  // scratch: 3 x [T, NX + NU, Bp] trajectories, then K [T, NU*NX, Bp], k [T, NU, Bp]
                // and, where the Riccati step's layout puts F and q there, those
                // [Bp/EX, kScratch, EX] (BoxStepLayout)
  float* bx;    // [T, NX, Bp] out: best x (zero-initialized by the wrapper)
  float* bu;    // [T, NU, Bp] out: best u (zero-initialized by the wrapper)
  float* bc;    // [Bp]        out: best cost
  float* bdu;   // [Bp]        out: full_du_norm of the best iterate
  int* iters;   // [Bp / 1024] out: iterations each tile ran
  long long* probe;  // [Bp / 1024, 3] out, or null: per tile the votes, the
                     // cycles in votes and the cycles of the whole kernel
                     // (rank 0, thread 0)
  int* smids;        // [blocks] out, or null: the SM each block ran on
  const float* F;    // a LinDx problem's [T-1, NX*N, Bp] dynamics, else null
  const float* f;    // [T-1, NX, Bp] or null
};

// n_ctrl == 1 keeps V, Q and F in registers up to kRegisterNx states (the
// envs with device code have at most 6); a LinDx problem with more puts
// them in shared memory, as the box-QP path does
constexpr int kRegisterNx = 6;
template <class Env, int NU>
constexpr bool kRegisterPath = NU == 1 && Env::NX <= kRegisterNx;

// dynamic shared memory of a block of EX examples
template <class Env, int NU>
constexpr size_t smem_bytes(int EX) {
  return kRegisterPath<Env, NU> ? 0 : sizeof(float) * BoxStepLayout<Env, NU>::kFloats * EX;
}

// The cost form of a QuadCost (LANES picks which); any other Cost is a
// callable cost generated by ops/cuda/traced.py (traced::Cost, its
// cost<S, P>(tau, params) a template over the scalar).
struct QuadForm {};

// The solve of one example (one thread). LANES: the per-example cost
// (entries Bp apart), else the example-invariant one (adjacent entries,
// compile-time offsets). Cost: QuadForm, or a callable cost, whose true
// value is the objective of the rollouts and the line search and whose
// (H, g) at tau (quad_at, forward over forward) the Riccati step takes in
// place of (C, C tau + c) -- the JAX kernel's cost_mode "callable"
// (ilqr_fused.py:734, :1045-1080, :1188, :1285); its params are a.C,
// read through the read-only cache.
template <class Env, int NU, int EX, bool LANES, class Cost = QuadForm>
__device__ __forceinline__ void ilqr_solve(const Args& a) {
  static_assert(NU == Env::NU, "the env's control count");
  static_assert(EX % 32 == 0 && EX <= 32 * kMaxWarps, "whole warps, at most kMaxWarps");
  constexpr int NX = Env::NX;
  constexpr int N = NX + NU;
  const int T = a.T, Bp = a.Bp;
  const int b = blockIdx.x * EX + threadIdx.x;
  const size_t sX = (size_t)NX * Bp;       // per-t stride of [T, NX, Bp]
  const size_t sU = (size_t)NU * Bp;       // per-t stride of [T, NU, Bp]
  const size_t sK = (size_t)NU * NX * Bp;  // per-t stride of [T, NU*NX, Bp]

  const long long t_start = clock64();
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ unsigned vote_words[2 * kMaxWarps];
  TileVote vote{vote_words, 0, 0};
  extern __shared__ float box_store[];  // strided path: V, Q, F [entry][example]

  Env env;
  env.load(a.params);
  if constexpr (kDataEnv<Env>) env.bind(a.F, a.f, Bp, b);
  // this example's bounds at step t: static, or per step and example
  auto bounds_at = [&](int t, float* lo, float* hi) {
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      lo[r] = a.lb ? a.lb[t * sU + r * Bp + b] : a.lo[r];
      hi[r] = a.ub ? a.ub[t * sU + r * Bp + b] : a.hi[r];
    }
  };

  // x_init is read where a sweep starts, not held in registers across
  // the iterations
  const float* x0 = a.x_init + b;

  // three trajectory buffers, each x [T, NX, Bp] then u [T, NU, Bp]: the
  // reference, the trial and the best iterate. An accepted trial becomes
  // the reference where it lies; the best stays in its buffer until the
  // end, when it is copied out once.
  const size_t sTraj = (size_t)T * (sX + sU);
  auto xbuf = [&](int i) { return a.work + i * sTraj; };
  auto ubuf = [&](int i) { return a.work + i * sTraj + T * sX; };
  int ref = 0, best = -1;   // buffer indices; -1: no best yet
  float* xr = xbuf(ref);    // reference trajectory
  float* ur = ubuf(ref);
  float* Kg = a.work + 3 * sTraj;  // feedback gains
  float* kg = Kg + T * sK;         // feedforward gains
  // the step's Jacobian and q where the layout keeps them here,
  // [entry][example] a block as in shared memory: the compile-time stride
  // EX. With the per-example cost an env that computes its Jacobian forms
  // the pointer again at each step, so that it holds no registers across
  // the solve (measured on the rocket: 696 bytes of spill stores, 1,232
  // with it held); the others hold it (forming it again cost the rocket's
  // example-invariant cost 4% of the kernel's time, and LinDx (15, 2) 112
  // bytes of stack).
  constexpr bool kReform = LANES && BoxStepLayout<Env, NU>::kSplit && !kDataEnv<Env>;
  auto f_scratch = [&]() {
    float* w = kReform ? opaque(a.work) : a.work;
    return w + 3 * sTraj + T * sK + T * sU +
           (size_t)blockIdx.x * BoxStepLayout<Env, NU>::kScratch * EX + threadIdx.x;
  };
  [[maybe_unused]] float* const Fs = kReform ? nullptr : f_scratch();

  // step t's cost of this example (CostView): the example-invariant form's
  // entries are adjacent, the per-example form's Bp apart
  auto cost_at = [&](int t) {
    if constexpr (LANES) {
      return CostView{a.C + (size_t)t * N * N * Bp + b, a.c + (size_t)t * N * Bp + b, Bp};
    } else {
      const int tc = a.Tc > 1 ? t : 0;
      return CostView{a.C + (size_t)tc * N * N, a.c + (size_t)tc * N, 1};
    }
  };
  // step t's objective at tau, and what the Riccati step reads of the cost
  // (a CostView, or a callable cost's CostQuad at tau)
  constexpr bool kCallable = !std::is_same_v<Cost, QuadForm>;
  auto obj_at = [&](int t, const float* tau) {
    if constexpr (kCallable) {
      return Cost::cost(tau, a.C);
    } else {
      return objective<N>(tau, cost_at(t));
    }
  };
  auto quad_of = [&](int t, const float* tau) {
    if constexpr (kCallable) {
      return quad_at<Cost, N>(tau, a.C);
    } else {
      return cost_at(t);
    }
  };

  // ---- 1) initial open-loop rollout and objective ----
  float oc = 0.0f;
  {
    float xt[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x0[i * Bp];
    for (int t = 0; t < T; ++t) {
      float tau[N];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        xr[t * sX + i * Bp + b] = xt[i];
        tau[i] = xt[i];
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const float ut = a.u_init ? a.u_init[t * sU + j * Bp + b] : 0.0f;
        ur[t * sU + j * Bp + b] = ut;
        tau[NX + j] = ut;
      }
      oc += obj_at(t, tau);
      if constexpr (kDataEnv<Env>) {
        if (t == T - 1) break;  // no F at T-1: the step would be discarded
        env.at(t);
      }
      float xn[NX];
      env.step(xt, tau + NX, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) xt[i] = xn[i];
    }
  }

  float bc = INFINITY, bdu = INFINITY;
  int nni = 0, iters = 0;
  for (int it = 0; it < a.lqr_iter; ++it) {
    // ---- 2-5) reverse Riccati with F_t = jac(x_t, u_t) (zero at T-1),
    // the delta-space shift C tau + c, the box-QP gains and the V/v
    // update ----
    float v[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) v[i] = 0.0f;
    // V in registers on the register path, else in shared memory
    constexpr bool kRegs = kRegisterPath<Env, NU>;
    [[maybe_unused]] float V[kRegs ? NX : 1][kRegs ? NX : 1];
    if constexpr (kRegs) {
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) V[i][j] = 0.0f;
    }
    for (int t = T - 1; t >= 0; --t) {
      float tau[N];
#pragma unroll
      for (int i = 0; i < NX; ++i) tau[i] = xr[t * sX + i * Bp + b];
#pragma unroll
      for (int j = 0; j < NU; ++j) tau[NX + j] = ur[t * sU + j * Bp + b];
      const auto cost = quad_of(t, tau);
      float lo[NU], hi[NU];
      bounds_at(t, lo, hi);
      if constexpr (kDataEnv<Env>) {
        if (t < T - 1) env.at(t);  // F_t for the Jacobian
      }

      if constexpr (kRegs) {
        float F[NX][N];
        if (t < T - 1) {
          env.jac(tau, tau + NX, F);
        } else {
#pragma unroll
          for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j) F[i][j] = 0.0f;
        }

        // q_i = (C tau + c)_i + (F^T v)_i
        auto q_entry = [&](int i) {
          const float cb = cost.template shift<N>(i, tau);
          float fv = 0.0f;
#pragma unroll
          for (int k = 0; k < NX; ++k) fv += F[k][i] * v[k];
          return cb + fv;
        };
        // Q = C + F^T V F (symmetric: upper triangle, mirrored). Both
        // orders sum each entry alike (the same bits); ptxas keeps the
        // slew-rate wrappers in registers with V F formed a column at a
        // time, the other envs with the whole of V F first (measured:
        // either the other way spills 8 bytes).
        float Q[N][N], q[N];
        if constexpr (Env::kColumnwiseQ) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            float tj[NX];
#pragma unroll
            for (int i = 0; i < NX; ++i) {
              float s = 0.0f;
#pragma unroll
              for (int k = 0; k < NX; ++k) s += V[k][i] * F[k][j];
              tj[i] = s;
            }
#pragma unroll
            for (int i = 0; i <= j; ++i) {
              float s = 0.0f;
#pragma unroll
              for (int k = 0; k < NX; ++k) s += F[k][i] * tj[k];
              Q[i][j] = cost.Ce(i * N + j) + s;
              Q[j][i] = Q[i][j];
            }
          }
#pragma unroll
          for (int i = 0; i < N; ++i) q[i] = q_entry(i);
        } else {
          float tmp[NX][N];  // V F
#pragma unroll
          for (int i = 0; i < NX; ++i)
#pragma unroll
            for (int j = 0; j < N; ++j) {
              float s = 0.0f;
#pragma unroll
              for (int k = 0; k < NX; ++k) s += V[k][i] * F[k][j];
              tmp[i][j] = s;
            }
#pragma unroll
          for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int j = i; j < N; ++j) {
              float s = 0.0f;
#pragma unroll
              for (int k = 0; k < NX; ++k) s += F[k][i] * tmp[k][j];
              Q[i][j] = cost.Ce(i * N + j) + s;
              Q[j][i] = Q[i][j];
            }
            q[i] = q_entry(i);
          }
        }

        const float ut = tau[NX];
        const float H = Q[NX][NX];
        const float qu = q[NX];
        float kt, If, Hinv;
        if (a.uz_free) {
          // the free subspace of an unboxed masked solve; k divides by
          // the unmasked Quu (the reference's quirk, :1328-1331)
          const float Iz = a.uz[t * sU + b] ? 1.0f : 0.0f;
          If = 1.0f - Iz;
          kt = -(qu * If) / H;
          Hinv = 1.0f / (H * If * If + 1e-8f * Iz);
        } else {
          // exact closed-form 1-D box-QP in delta space, the bounds
          // intersected with +-delta_u
          float lb = lo[0] - ut, ub = hi[0] - ut;
          if (a.has_du) {
            lb = maximum(lb, -a.du);
            ub = minimum(ub, a.du);
          }
          kt = clip(-qu / H, lb, ub);
          const float g = H * kt + qu;
          const bool Ic = (kt <= lb && g > 0.0f) || (kt >= ub && g < 0.0f);
          If = Ic ? 0.0f : 1.0f;
          Hinv = 1.0f / (H * If + 1e-11f);
        }
        float K[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          K[j] = -(Hinv * (Q[NX][j] * If));
          Kg[t * sK + j * Bp + b] = K[j];
        }
        kg[t * sU + b] = kt;

        // V' = Qxx + Qxu K + (Qxu K)^T + K^T Quu K; v' = qx + Qxu k + K^T (qu + Quu k)
        const float qk = qu + H * kt;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j)
            V[i][j] = Q[i][j] + Q[i][NX] * K[j] + Q[j][NX] * K[i] + K[i] * (H * K[j]);
          v[i] = q[i] + Q[i][NX] * kt + K[i] * qk;
        }
      } else {
        // V and Q in shared memory, F there or in device memory; the
        // step is riccati_box_step
        float warm[NU], K[NU][NX], kt[NU];
        if (t < T - 1) {
          // warm start with the next step's k of this sweep
#pragma unroll
          for (int r = 0; r < NU; ++r) warm[r] = kg[(t + 1) * sU + r * Bp + b];
        }
        StepVariant<NU> var{a.has_du, a.du, a.uz_free, {}};
        if (a.uz_free) {
#pragma unroll
          for (int r = 0; r < NU; ++r) var.Iz[r] = a.uz[t * sU + r * Bp + b] ? 1.0f : 0.0f;
        }
        riccati_box_step<Env, NU>(env, t == T - 1, tau, cost, lo, hi, var, warm, a.pnqp_iter,
                                  vote, box_store + threadIdx.x, EX, kReform ? f_scratch() : Fs,
                                  EX, v, K, kt);
#pragma unroll
        for (int r = 0; r < NU; ++r) {
#pragma unroll
          for (int j = 0; j < NX; ++j) Kg[t * sK + (r * NX + j) * Bp + b] = K[r][j];
          kg[t * sU + r * Bp + b] = kt[r];
        }
      }
    }

    // ---- 6) backtracking line search, recording the trial trajectory in
    // the buffer that is neither the reference nor the best; the first
    // trial always runs and its du2 is full_du_norm ----
    const int trial = ref != 0 && best != 0 ? 0 : (ref != 1 && best != 1 ? 1 : 2);
    float* xq = xbuf(trial);
    float* uq = ubuf(trial);
    float alpha = 1.0f, cc = 0.0f, du2s = 0.0f;
    for (int i = 0; i < a.max_ls_iter; ++i) {
      if (i == 0 || vote.any(cc > oc)) {
        float xt[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) xt[j] = x0[j * Bp];
        float cost = 0.0f, du2 = 0.0f;
        for (int t = 0; t < T; ++t) {
          float tau[N], dsq = 0.0f, lo[NU], hi[NU];
          bounds_at(t, lo, hi);
#pragma unroll
          for (int r = 0; r < NU; ++r) {
            const float urt = ur[t * sU + r * Bp + b];
            float kdx = 0.0f;
#pragma unroll
            for (int j = 0; j < NX; ++j)
              kdx += Kg[t * sK + (r * NX + j) * Bp + b] * (xt[j] - xr[t * sX + j * Bp + b]);
            float new_u = kdx + urt + alpha * kg[t * sU + r * Bp + b];
            // masked coordinates zeroed before the clamp (:1399-1402)
            if (a.uz) new_u = new_u * (1.0f - (a.uz[t * sU + r * Bp + b] ? 1.0f : 0.0f));
            if (a.has_du) {
              // the clamp widened around the current iterate (:1404-1408)
              new_u = clip_ordered(new_u, maximum(urt - a.du, lo[r]), minimum(urt + a.du, hi[r]));
            } else {
              new_u = clip(new_u, lo[r], hi[r]);
            }
            const float d = urt - new_u;
            if constexpr (NU == 1) {
              du2 += d * d;
            } else {
              dsq += d * d;  // du2 + sum over the controls, as the JAX kernel adds
            }
            uq[t * sU + r * Bp + b] = new_u;
            tau[NX + r] = new_u;
          }
          if constexpr (NU > 1) du2 += dsq;
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            xq[t * sX + j * Bp + b] = xt[j];
            tau[j] = xt[j];
          }
          cost += obj_at(t, tau);
          if constexpr (kDataEnv<Env>) {
            if (t == T - 1) break;
            env.at(t);
          }
          float xn[NX];
          env.step(xt, tau + NX, xn);
#pragma unroll
          for (int j = 0; j < NX; ++j) xt[j] = xn[j];
        }
        cc = cost;
        if (i == 0) du2s = du2;
      }
      if (cc > oc) alpha *= a.ls_decay;
    }
    const float cur_du = sqrtf(du2s);

    // ---- 7) accept the last executed trial (its buffer becomes the
    // reference) and fold in best tracking with best_cost_eps ----
    const bool improved = cc <= bc + a.best_cost_eps;
    ref = trial;
    xr = xq;
    ur = uq;
    if (improved) {
      best = ref;
      bc = cc;
      bdu = cur_du;
    }
    oc = cc;

    // ---- 8) per-tile stopping rule: max(du) < eps or no improvement for
    // not_improved_lim iterations ----
    const int any_improved = vote.any(improved);
    nni = (it > 0 && any_improved) ? 0 : nni + 1;
    const int all_small = vote.all(cur_du < a.eps);
    ++iters;
    if (all_small || nni > a.not_improved_lim) break;
  }

  if (best >= 0) {
    const float* xb = xbuf(best);
    const float* ub = ubuf(best);
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int j = 0; j < NX; ++j) a.bx[t * sX + j * Bp + b] = xb[t * sX + j * Bp + b];
#pragma unroll
      for (int r = 0; r < NU; ++r) a.bu[t * sU + r * Bp + b] = ub[t * sU + r * Bp + b];
    }
  }
  a.bc[b] = bc;
  a.bdu[b] = bdu;
  const int tile = blockIdx.x / cluster.num_blocks();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    a.iters[tile] = iters;
    if (a.probe) {
      a.probe[3 * tile] = vote.n;
      a.probe[3 * tile + 1] = vote.cycles;
      a.probe[3 * tile + 2] = clock64() - t_start;
    }
  }
  if (a.smids && threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    a.smids[blockIdx.x] = (int)sm;
  }
  cluster.sync();  // no block leaves while a peer may still read its vote words
}

// The kernel, with the registers ptxas chooses.
template <class Env, int NU, int EX, bool LANES, class Cost>
__global__ void __launch_bounds__(EX) ilqr_fused_kernel(const Args a) {
  ilqr_solve<Env, NU, EX, LANES, Cost>(a);
}

// The kernel for at least MINB blocks an SM: ptxas then uses the registers
// that leaves instead of trading a spill for more blocks.
template <class Env, int NU, int EX, bool LANES, class Cost, int MINB>
__global__ void __launch_bounds__(EX, MINB) ilqr_fused_kernel_mb(const Args a) {
  ilqr_solve<Env, NU, EX, LANES, Cost>(a);
}

// Blocks of 128 threads an SM to state to ptxas, 0 for none: the
// instantiations whose default allocation spills (measured with
// -Xptxas -v; chip_smoke.py's phase 2 fails on a spill at n_ctrl == 1).
template <class Env, bool LANES>
constexpr int kMinBlocks128 = 0;
template <>
constexpr int kMinBlocks128<Pendulum, false> = 6;
// a LinDx shape asks for no more than 2 blocks of 128 threads an SM, a cap
// of 255 registers: at 64 threads a block, ptxas's own choice gave
// LinDx<3, 2> 72 registers and 76 bytes of spill where 80 do without
template <int NX, int NU, bool LANES>
constexpr int kMinBlocks128<LinDx<NX, NU>, LANES> = 2;
// so does the complex pendulum's jvp sweep (ilqr_jvp.cu) and its slew-rate
// wrapper: ptxas's own choice gave them 80-128 registers and 8-36 bytes of
// spill
template <bool C, bool LANES>
constexpr int kMinBlocks128<JvpJac<PendulumComplex, C>, LANES> = 2;
template <bool C, bool LANES>
constexpr int kMinBlocks128<Passthrough<JvpJac<PendulumComplex, C>>, LANES> = 2;
// and so do the MLP's (ilqr_mlp.cu): at 64 threads a block ptxas's own
// choice gave the golden's (3, 2, (16,)) 72 registers and 68 bytes of spill
template <bool C, bool LANES, int NX, int NU, int ACT, bool R, int... H>
constexpr int kMinBlocks128<JvpJac<Mlp<NX, NU, ACT, R, H...>, C>, LANES> = 2;
template <bool C, bool LANES, int NX, int NU, int ACT, bool R, int... H>
constexpr int kMinBlocks128<Passthrough<JvpJac<Mlp<NX, NU, ACT, R, H...>, C>>, LANES> = 2;
// the hand Jacobian's (one hidden layer, ANALYTIC) likewise
template <bool LANES, int NX, int NU, int ACT, bool R, int... H>
constexpr int kMinBlocks128<Mlp<NX, NU, ACT, R, H...>, LANES> = 2;
template <bool LANES, int NX, int NU, int ACT, bool R, int... H>
constexpr int kMinBlocks128<Passthrough<Mlp<NX, NU, ACT, R, H...>>, LANES> = 2;
// and so does a traced user model's (ilqr_user.cu), whose generated step is
// long straight-line code: ptxas may use up to 255 registers a thread
// rather than trade spills for occupancy
template <bool C, bool LANES, class M>
constexpr int kMinBlocks128<JvpJac<Traced<M>, C>, LANES> = 2;

template <class Env, int NU, int EX, bool LANES, class Cost>
constexpr auto kernel_of() {
  constexpr int mb = kMinBlocks128<Env, LANES> * 128 / EX;
  if constexpr (mb > 0) {
    return ilqr_fused_kernel_mb<Env, NU, EX, LANES, Cost, mb>;
  } else {
    return ilqr_fused_kernel<Env, NU, EX, LANES, Cost>;
  }
}

// The kernel of (Env, NU, cost form) for a tile of G blocks, with its
// launch shape.
template <class Env, int NU, int EX, bool LANES, class Cost = QuadForm>
struct Launch {
  static cudaError_t configure(int G, size_t smem) {
    auto kernel = kernel_of<Env, NU, EX, LANES, Cost>();
    cudaError_t e = cudaSuccess;
    if (smem > 0)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && G > 8)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }

  static void config(int blocks, int G, size_t smem, cudaStream_t st, cudaLaunchConfig_t* cfg,
                     cudaLaunchAttribute* attr) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = G;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(blocks);
    cfg->blockDim = dim3(EX);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = st;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
  }

  static cudaError_t run(const Args& a, int G, cudaStream_t st) {
    const size_t smem = smem_bytes<Env, NU>(EX);
    cudaError_t e = configure(G, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    config(a.Bp / EX, G, smem, st, &cfg, &attr);
    e = cudaLaunchKernelEx(&cfg, kernel_of<Env, NU, EX, LANES, Cost>(), a);
    return e != cudaSuccess ? e : cudaGetLastError();
  }

  // out: max active clusters, registers, local bytes a thread, static and
  // dynamic shared bytes a block
  static cudaError_t info(int G, int* out) {
    const size_t smem = smem_bytes<Env, NU>(EX);
    cudaError_t e = configure(G, smem);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    config(G, G, smem, nullptr, &cfg, &attr);
    auto kernel = kernel_of<Env, NU, EX, LANES, Cost>();
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, (const void*)kernel);
    if (e != cudaSuccess) return e;
    out[0] = clusters;
    out[1] = fa.numRegs;
    out[2] = (int)fa.localSizeBytes;
    out[3] = (int)fa.sharedSizeBytes;
    out[4] = (int)smem;
    return cudaSuccess;
  }
};

constexpr size_t kMaxSmem = 232448;  // dynamic shared bytes a Hopper block may have

// the cost form takes the env's tau: a QuadCost any, a callable cost one of
// its own length
template <class Env, int NU, class Cost>
constexpr bool cost_fits() {
  if constexpr (std::is_same_v<Cost, QuadForm>) {
    return true;
  } else {
    return Cost::N == Env::NX + NU;
  }
}

// f(Launch<Env, NU, EX, LANES, Cost>{}) where a block of EX examples fits
// the shared memory and the cost the env, else cudaErrorInvalidValue (no
// such instantiation)
template <class Env, int NU, int EX, bool LANES, class Cost = QuadForm, class F>
cudaError_t launch_if_fits(F f) {
  if constexpr (smem_bytes<Env, NU>(EX) <= kMaxSmem && cost_fits<Env, NU, Cost>()) {
    return f(Launch<Env, NU, EX, LANES, Cost>{});
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace dilqr
