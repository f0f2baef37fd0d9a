// Whole-solve batched iLQR kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ilqr_kernel` in
// dilqr_tpu/ops/pallas/ilqr_fused.py (called through `ilqr_fused`), for the
// configurations the port runs: static per-control bounds, an
// example-invariant cost ([n,n] or [T,n,n]), a zero or given warm start,
// the env's hand-derived Jacobian, f32, and
//  * n_ctrl == 1 (cartpole, simple pendulum): the closed-form 1-D box-QP;
//  * n_ctrl == 3 (the rocket): the in-kernel projected-Newton box-QP
//    (`_pnqp_lanes`) with its closed-form inverses (`_inv_lanes`), warm
//    started with k_{t+1} (at t = T-1 with the clipped ridged Newton point),
//    and gains K = -inv(H_free) (Q_ux * If) from its last Newton step.
//
// Design. One thread per example, 1024 threads per block: a block is the
// JAX kernel's 1024-example tile, so the decisions that kernel takes per
// tile -- the line search's any(cost worsened), the not-improved reset's
// any(improved), the stopping rule's max(du) < eps, and inside every
// Riccati step the box-QP's Newton exit (no example still steps) and
// Armijo exit (max(armijo) > 0.1) -- are block votes (__syncthreads_or /
// __syncthreads_and; a NaN du makes both forms false, a NaN armijo ends
// the Armijo loop). Every branch around a vote is block-uniform: a thread
// whose example is done keeps reaching the votes, and a block whose tile
// has stopped leaves the outer loop as a whole. Per-step arrays (reference
// and trial trajectory, gains K/k) live in global scratch the wrapper
// allocates, laid out [T, k, Bp] with the control axis inside k (u [T, NU,
// Bp], K [T, NU*NX, Bp]) so a warp's accesses coalesce; the reference and
// trial buffers swap roles on accept instead of copying. The cost-to-go V,
// v, Q and the gains of one step stay in registers or local memory, and
// the Jacobian F is formed at the use site (no [T, nx, n] buffer); only
// Q's upper triangle is computed. The cost is read through the read-only
// cache (every thread of a warp reads the same address).
//
// What bounds it. The work is a long sequential recursion per example
// (T steps x lqr_iter iterations x Riccati + line search) with little data:
// it is bound by operations and their latency, not by bytes. A block needs
// 1024 examples, so B=4096 fills 4 of the 132 SMs and B=16384 16, and
// __launch_bounds__(1024) caps a thread at 64 registers: the 5x5 V, the 6x6
// Q and the 5x6 Jacobian spill to local memory (L1/L2), and the rocket's
// 13x13 V, 16x16 Q and 13x16 F live there entirely. Both limits follow
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
  const float* u_init;  // [T, NU, Bp] or null (zeros)
  float lo[kMaxNu], hi[kMaxNu];  // static per-control bounds, +-inf for none
  int lqr_iter, max_ls_iter, not_improved_lim, pnqp_iter;
  float eps, ls_decay, best_cost_eps;
  float* work;  // [T, 2*NX + 3*NU + NU*NX, Bp] scratch
  float* bx;    // [T, NX, Bp] out: best x (zero-initialized by the wrapper)
  float* bu;    // [T, NU, Bp] out: best u (zero-initialized by the wrapper)
  float* bc;    // [Bp]        out: best cost
  float* bdu;   // [Bp]        out: full_du_norm of the best iterate
  int* iters;   // [Bp / 1024] out: iterations each tile ran
};

template <class Env, int NU>
__global__ void __launch_bounds__(1024) ilqr_fused_kernel(const Args a) {
  static_assert(NU == Env::NU, "the env's control count");
  constexpr int NX = Env::NX;
  constexpr int N = NX + NU;
  const int T = a.T, Bp = a.Bp;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t sX = (size_t)NX * Bp;       // per-t stride of [T, NX, Bp]
  const size_t sU = (size_t)NU * Bp;       // per-t stride of [T, NU, Bp]
  const size_t sK = (size_t)NU * NX * Bp;  // per-t stride of [T, NU*NX, Bp]

  Env env;
  env.load(a.params);

  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = a.x_init[i * Bp + b];

  float* xr = a.work;       // reference trajectory
  float* ur = xr + T * sX;
  float* xq = ur + T * sU;  // trial trajectory
  float* uq = xq + T * sX;
  float* Kg = uq + T * sU;  // feedback gains
  float* kg = Kg + T * sK;  // feedforward gains

  auto Cat = [&](int t) { return a.Cs + (size_t)(a.Tc > 1 ? t : 0) * N * N; };
  auto cat = [&](int t) { return a.cs + (size_t)(a.Tc > 1 ? t : 0) * N; };

  // ---- 1) initial open-loop rollout and objective ----
  float oc = 0.0f;
  {
    float xt[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x0[i];
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
      oc += objective<N>(tau, Cat(t), cat(t));
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
#pragma unroll
      for (int j = 0; j < NU; ++j) tau[NX + j] = ur[t * sU + j * Bp + b];
      const float* C = Cat(t);
      const float* c = cat(t);

      float F[NX][N];
      if (t < T - 1) {
        env.jac(tau, tau + NX, F);
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

      if constexpr (NU == 1) {
        // exact closed-form 1-D box-QP in delta space
        const float ut = tau[NX];
        const float H = Q[NX][NX];
        const float qu = q[NX];
        const float lb = a.lo[0] - ut, ub = a.hi[0] - ut;
        const float kt = clip(-qu / H, lb, ub);
        const float g = H * kt + qu;
        const bool Ic = (kt <= lb && g > 0.0f) || (kt >= ub && g < 0.0f);
        const float If = Ic ? 0.0f : 1.0f;
        const float Hinv = 1.0f / (H * If + 1e-11f);
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
        // projected-Newton box-QP in delta space
        float H[NU][NU], qu[NU], lb[NU], ub[NU], warm[NU];
#pragma unroll
        for (int r = 0; r < NU; ++r) {
          qu[r] = q[NX + r];
          lb[r] = a.lo[r] - tau[NX + r];
          ub[r] = a.hi[r] - tau[NX + r];
#pragma unroll
          for (int s = 0; s < NU; ++s) H[r][s] = Q[NX + r][NX + s];
        }
        if (t < T - 1) {
          // warm start with the next step's k of this sweep
#pragma unroll
          for (int r = 0; r < NU; ++r) warm[r] = kg[(t + 1) * sU + r * Bp + b];
        } else {
          // clip(-inv(Quu + 1e-11 I) qu, lb, ub)
          float Hr[NU][NU], Hri[NU][NU];
#pragma unroll
          for (int r = 0; r < NU; ++r)
#pragma unroll
            for (int s = 0; s < NU; ++s) Hr[r][s] = H[r][s] + (r == s ? kPnqpReg : 0.0f);
          inv_small<NU>(Hr, Hri);
          mv_small<NU>(Hri, qu, warm);
#pragma unroll
          for (int r = 0; r < NU; ++r) warm[r] = clip(-warm[r], lb[r], ub[r]);
        }
        float kt[NU], If[NU], Hf[NU][NU], Hinv[NU][NU];
        pnqp<NU>(H, qu, lb, ub, warm, a.pnqp_iter, kt, If, Hf);

        // K = -inv(H_free) (Q_ux * If): active rows of Q_ux zeroed
        inv_small<NU>(Hf, Hinv);
        float K[NU][NX];
#pragma unroll
        for (int r = 0; r < NU; ++r) {
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float s = 0.0f;
#pragma unroll
            for (int m = 0; m < NU; ++m) s += Hinv[r][m] * (Q[NX + m][j] * If[m]);
            K[r][j] = -s;
            Kg[t * sK + (r * NX + j) * Bp + b] = K[r][j];
          }
          kg[t * sU + r * Bp + b] = kt[r];
        }

        // V' = Qxx + M + M^T + K^T (Quu K) with M = Qxu K (the last term
        // symmetric: upper triangle, mirrored);
        // v' = qx + Qxu k + K^T (qu + Quu k)
        float QK[NU][NX], qk[NU];
#pragma unroll
        for (int r = 0; r < NU; ++r) {
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float s = 0.0f;
#pragma unroll
            for (int m = 0; m < NU; ++m) s += Q[NX + r][NX + m] * K[m][j];
            QK[r][j] = s;
          }
          float s = 0.0f;
#pragma unroll
          for (int m = 0; m < NU; ++m) s += Q[NX + r][NX + m] * kt[m];
          qk[r] = qu[r] + s;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            float mij = 0.0f, mji = 0.0f, kqk = 0.0f;
            const int lo = i < j ? i : j, hi = i < j ? j : i;
#pragma unroll
            for (int r = 0; r < NU; ++r) {
              mij += Q[i][NX + r] * K[r][j];
              mji += Q[j][NX + r] * K[r][i];
              kqk += K[r][lo] * QK[r][hi];
            }
            V[i][j] = Q[i][j] + mij + mji + kqk;
          }
          float qxk = 0.0f, kq = 0.0f;
#pragma unroll
          for (int r = 0; r < NU; ++r) {
            qxk += Q[i][NX + r] * kt[r];
            kq += K[r][i] * qk[r];
          }
          v[i] = q[i] + qxk + kq;
        }
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
          float tau[N], dsq = 0.0f;
#pragma unroll
          for (int r = 0; r < NU; ++r) {
            const float urt = ur[t * sU + r * Bp + b];
            float kdx = 0.0f;
#pragma unroll
            for (int j = 0; j < NX; ++j)
              kdx += Kg[t * sK + (r * NX + j) * Bp + b] * (xt[j] - xr[t * sX + j * Bp + b]);
            const float new_u =
                clip(kdx + urt + alpha * kg[t * sU + r * Bp + b], a.lo[r], a.hi[r]);
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
          cost += objective<N>(tau, Cat(t), cat(t));
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
#pragma unroll
        for (int r = 0; r < NU; ++r) a.bu[t * sU + r * Bp + b] = ur[t * sU + r * Bp + b];
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

// lo/hi: host arrays of kMaxNu floats (the env's bounds first, padded),
// copied into the kernel's arguments.
extern "C" int dilqr_ilqr_fused(int env, int T, int Bp, int Tc, const float* params,
                                const float* x_init, const float* Cs, const float* cs,
                                const float* u_init, const float* lo, const float* hi,
                                int lqr_iter, float eps, float ls_decay, int max_ls_iter,
                                float best_cost_eps, int not_improved_lim, int pnqp_iter,
                                float* work, float* bx, float* bu, float* bc, float* bdu,
                                int* iters, void* stream) {
  if (Bp <= 0 || Bp % 1024 != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  dilqr::Args a{T, Bp, Tc, params, x_init, Cs, cs, u_init, {}, {},
                lqr_iter, max_ls_iter, not_improved_lim, pnqp_iter, eps, ls_decay,
                best_cost_eps, work, bx, bu, bc, bdu, iters};
  for (int r = 0; r < dilqr::kMaxNu; ++r) {
    a.lo[r] = lo[r];
    a.hi[r] = hi[r];
  }
  const dim3 grid(Bp / 1024), block(1024);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (env) {
    case dilqr::ENV_CARTPOLE:
      dilqr::ilqr_fused_kernel<dilqr::Cartpole, 1><<<grid, block, 0, st>>>(a);
      break;
    case dilqr::ENV_PENDULUM:
      dilqr::ilqr_fused_kernel<dilqr::Pendulum, 1><<<grid, block, 0, st>>>(a);
      break;
    case dilqr::ENV_ROCKET:
      dilqr::ilqr_fused_kernel<dilqr::Rocket, 3><<<grid, block, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
