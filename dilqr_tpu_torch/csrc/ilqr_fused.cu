// Whole-solve batched iLQR kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ilqr_kernel` in
// dilqr_tpu/ops/pallas/ilqr_fused.py (called through `ilqr_fused`), for the
// configuration the main path runs: n_ctrl == 1 with the closed-form 1-D
// box-QP, static bounds, an example-invariant cost ([n,n] or [T,n,n]), a
// zero or given warm start, the env's hand-derived Jacobian (cartpole,
// simple pendulum), f32.
//
// Design. One thread per example, 1024 threads per block: a block is the
// JAX kernel's 1024-example tile, so the decisions that kernel takes per
// tile -- the line search's any(cost worsened), the not-improved reset's
// any(improved), the stopping rule's max(du) < eps -- are block votes
// (__syncthreads_or / __syncthreads_and; a NaN du makes both forms false).
// Every branch around a vote is block-uniform, and a block whose tile has
// stopped leaves the outer loop as a whole. Per-step arrays (reference and
// trial trajectory, gains K/k) live in global scratch the wrapper
// allocates, laid out [T, k, Bp] so a warp's accesses coalesce; the
// reference and trial buffers swap roles on accept instead of copying.
// The cost-to-go V, v, Q and the gains of one step stay in registers or
// local memory; the cost is read through the read-only cache (every thread
// of a warp reads the same address).
//
// What bounds it. The work is a long sequential recursion per example
// (T steps x lqr_iter iterations x Riccati + line search) with little data:
// it is bound by operations and their latency, not by bytes. A block needs
// 1024 examples, so B=4096 fills 4 of the 132 SMs and B=16384 16, and
// __launch_bounds__(1024) caps a thread at 64 registers: the 5x5 V, the 6x6
// Q and the 5x6 Jacobian spill to local memory (L1/L2). Both limits follow
// from keeping the tile semantics; PERF.md has the measured times and the
// -Xptxas -v report. Making it fast is later work.
//
// Numerics: f32, compiled without -use_fast_math (cosf/sinf are the
// accurate versions, division and sqrt IEEE-rounded); rsqrtf and nvcc's
// default FMA contraction move results by a few ulp from the plain
// PyTorch version, which the tests' tolerances state.
#include <cuda_runtime.h>
#include <math.h>

#include "ilqr_fused.cuh"

namespace dilqr {

struct Args {
  int T, Bp, Tc;
  const float* params;  // [P]
  const float* x_init;  // [NX, Bp]
  const float* Cs;      // [Tc, N*N]
  const float* cs;      // [Tc, N]
  const float* u_init;  // [T, Bp] or null (zeros)
  float lo, hi;         // static bounds, +-inf for none
  int lqr_iter, max_ls_iter, not_improved_lim;
  float eps, ls_decay, best_cost_eps;
  float* work;  // [T, 3*NX + 3, Bp] scratch
  float* bx;    // [T, NX, Bp] out: best x (zero-initialized by the wrapper)
  float* bu;    // [T, Bp]     out: best u (zero-initialized by the wrapper)
  float* bc;    // [Bp]        out: best cost
  float* bdu;   // [Bp]        out: full_du_norm of the best iterate
  int* iters;   // [Bp / 1024] out: iterations each tile ran
};

template <class Env>
__global__ void __launch_bounds__(1024) ilqr_fused_kernel(const Args a) {
  constexpr int NX = Env::NX;
  constexpr int N = NX + 1;
  const int T = a.T, Bp = a.Bp;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t sX = (size_t)NX * Bp;  // per-t stride of [T, NX, Bp]

  Env env;
  env.load(a.params);

  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = a.x_init[i * Bp + b];

  float* xr = a.work;               // reference trajectory
  float* ur = xr + T * sX;
  float* xq = ur + (size_t)T * Bp;  // trial trajectory
  float* uq = xq + T * sX;
  float* Kg = uq + (size_t)T * Bp;  // feedback gains
  float* kg = Kg + T * sX;          // feedforward gains

  auto Cat = [&](int t) { return a.Cs + (size_t)(a.Tc > 1 ? t : 0) * N * N; };
  auto cat = [&](int t) { return a.cs + (size_t)(a.Tc > 1 ? t : 0) * N; };

  // ---- 1) initial open-loop rollout and objective ----
  float oc = 0.0f;
  {
    float xt[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x0[i];
    for (int t = 0; t < T; ++t) {
      const float ut = a.u_init ? a.u_init[(size_t)t * Bp + b] : 0.0f;
      float tau[N];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        xr[t * sX + i * Bp + b] = xt[i];
        tau[i] = xt[i];
      }
      ur[(size_t)t * Bp + b] = ut;
      tau[NX] = ut;
      oc += objective<N>(tau, Cat(t), cat(t));
      float xn[NX];
      env.step(xt, ut, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) xt[i] = xn[i];
    }
  }

  float bc = INFINITY, bdu = INFINITY;
  int nni = 0, iters = 0;
  for (int it = 0; it < a.lqr_iter; ++it) {
    // ---- 2-5) reverse Riccati with F_t = jac(x_t, u_t) (zero at T-1),
    // the delta-space shift C tau + c, the closed-form box-QP gains and
    // the V/v update ----
    float V[NX][NX], v[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      v[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) V[i][j] = 0.0f;
    }
    for (int t = T - 1; t >= 0; --t) {
      float tau[N];
#pragma unroll
      for (int i = 0; i < NX; ++i) tau[i] = xr[t * sX + i * Bp + b];
      const float ut = ur[(size_t)t * Bp + b];
      tau[NX] = ut;
      const float* C = Cat(t);
      const float* c = cat(t);

      float F[NX][N];
      if (t < T - 1) {
        env.jac(tau, ut, F);
      } else {
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < N; ++j) F[i][j] = 0.0f;
      }

      // tmp = V F
      float tmp[NX][N];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < NX; ++k) s += V[k][i] * F[k][j];
          tmp[i][j] = s;
        }
      // Q = C + F^T V F (symmetric: upper triangle, mirrored);
      // q = C tau + c + F^T v
      float Q[N][N], q[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = i; j < N; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < NX; ++k) s += F[k][i] * tmp[k][j];
          Q[i][j] = __ldg(&C[i * N + j]) + s;
          Q[j][i] = Q[i][j];
        }
        float cb = 0.0f;
#pragma unroll
        for (int j = 0; j < N; ++j) cb += __ldg(&C[i * N + j]) * tau[j];
        cb += __ldg(&c[i]);
        float fv = 0.0f;
#pragma unroll
        for (int k = 0; k < NX; ++k) fv += F[k][i] * v[k];
        q[i] = cb + fv;
      }

      // exact closed-form 1-D box-QP in delta space
      const float H = Q[NX][NX];
      const float qu = q[NX];
      const float lb = a.lo - ut, ub = a.hi - ut;
      const float kt = clip(-qu / H, lb, ub);
      const float g = H * kt + qu;
      const bool Ic = (kt <= lb && g > 0.0f) || (kt >= ub && g < 0.0f);
      const float If = Ic ? 0.0f : 1.0f;
      const float Hinv = 1.0f / (H * If + 1e-11f);
      float K[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        K[j] = -(Hinv * (Q[NX][j] * If));
        Kg[t * sX + j * Bp + b] = K[j];
      }
      kg[(size_t)t * Bp + b] = kt;

      // V' = Qxx + Qxu K + (Qxu K)^T + K^T Quu K; v' = qx + Qxu k + K^T (qu + Quu k)
      const float qk = qu + H * kt;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j)
          V[i][j] = Q[i][j] + Q[i][NX] * K[j] + Q[j][NX] * K[i] + K[i] * (H * K[j]);
        v[i] = q[i] + Q[i][NX] * kt + K[i] * qk;
      }
    }

    // ---- 6) backtracking line search, recording the trial trajectory;
    // the first trial always runs and its du2 is full_du_norm ----
    float alpha = 1.0f, cc = 0.0f, du2s = 0.0f;
    for (int i = 0; i < a.max_ls_iter; ++i) {
      if (i == 0 || __syncthreads_or(cc > oc)) {
        float xt[NX];
#pragma unroll
        for (int j = 0; j < NX; ++j) xt[j] = x0[j];
        float cost = 0.0f, du2 = 0.0f;
        for (int t = 0; t < T; ++t) {
          const float urt = ur[(size_t)t * Bp + b];
          float kdx = 0.0f;
#pragma unroll
          for (int j = 0; j < NX; ++j)
            kdx += Kg[t * sX + j * Bp + b] * (xt[j] - xr[t * sX + j * Bp + b]);
          const float new_u = clip(kdx + urt + alpha * kg[(size_t)t * Bp + b], a.lo, a.hi);
          const float d = urt - new_u;
          du2 += d * d;
          float tau[N];
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            xq[t * sX + j * Bp + b] = xt[j];
            tau[j] = xt[j];
          }
          uq[(size_t)t * Bp + b] = new_u;
          tau[NX] = new_u;
          cost += objective<N>(tau, Cat(t), cat(t));
          float xn[NX];
          env.step(xt, new_u, xn);
#pragma unroll
          for (int j = 0; j < NX; ++j) xt[j] = xn[j];
        }
        cc = cost;
        if (i == 0) du2s = du2;
      }
      if (cc > oc) alpha *= a.ls_decay;
    }
    const float cur_du = sqrtf(du2s);

    // ---- 7) accept the last executed trial (swap the buffers) and fold
    // in best tracking with best_cost_eps ----
    const bool improved = cc <= bc + a.best_cost_eps;
    float* s;
    s = xr; xr = xq; xq = s;
    s = ur; ur = uq; uq = s;
    if (improved) {
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int j = 0; j < NX; ++j) a.bx[t * sX + j * Bp + b] = xr[t * sX + j * Bp + b];
        a.bu[(size_t)t * Bp + b] = ur[(size_t)t * Bp + b];
      }
      bc = cc;
      bdu = cur_du;
    }
    oc = cc;

    // ---- 8) per-tile stopping rule: max(du) < eps or no improvement for
    // not_improved_lim iterations ----
    const int any_improved = __syncthreads_or(improved);
    nni = (it > 0 && any_improved) ? 0 : nni + 1;
    const int all_small = __syncthreads_and(cur_du < a.eps);
    ++iters;
    if (all_small || nni > a.not_improved_lim) break;
  }

  a.bc[b] = bc;
  a.bdu[b] = bdu;
  if (threadIdx.x == 0) a.iters[blockIdx.x] = iters;
}

}  // namespace dilqr

extern "C" int dilqr_ilqr_fused(int env, int T, int Bp, int Tc, const float* params,
                                const float* x_init, const float* Cs, const float* cs,
                                const float* u_init, float lo, float hi, int lqr_iter,
                                float eps, float ls_decay, int max_ls_iter,
                                float best_cost_eps, int not_improved_lim, float* work,
                                float* bx, float* bu, float* bc, float* bdu, int* iters,
                                void* stream) {
  if (Bp <= 0 || Bp % 1024 != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  dilqr::Args a{T, Bp, Tc, params, x_init, Cs, cs, u_init, lo, hi,
                lqr_iter, max_ls_iter, not_improved_lim, eps, ls_decay, best_cost_eps,
                work, bx, bu, bc, bdu, iters};
  const dim3 grid(Bp / 1024), block(1024);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (env) {
    case dilqr::ENV_CARTPOLE:
      dilqr::ilqr_fused_kernel<dilqr::Cartpole><<<grid, block, 0, st>>>(a);
      break;
    case dilqr::ENV_PENDULUM:
      dilqr::ilqr_fused_kernel<dilqr::Pendulum><<<grid, block, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
