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
//  * n_ctrl == 1: the cost-to-go V, v, Q and the Jacobian F of one step are
//    registers; a block of 128 (or 64) threads lets a thread hold 255, so
//    nothing spills.
//  * n_ctrl == 3: the rocket's V (13x13), Q (16x16) and F (13x16) would
//    not fit in registers; they live in dynamic shared memory as triangles
//    (V, Q) and a dense F, [entry][example], 1740 bytes an example: 128
//    examples a block (G = 8) take 222,720 of the 232,448 bytes a block may
//    have, 64 (G = 16) half that. Q is formed four columns of V F at a time,
//    so each V entry is read once a column block. riccati_box_step in the
//    header is that step, built with g++ in the tests.
//
// What bounds it. The work is a long sequential recursion per example
// (T steps x lqr_iter iterations x Riccati + line search) with little data:
// it is bound by operations and their latency, not by bytes. A tile now
// spans G SMs (B=4096 fills 32 of the 132 SMs at G = 8, the rocket's
// B=1024 8), but each SM holds only 1024/G threads of it: few warps to hide
// latency behind. Each vote is a cluster barrier; the rocket takes several
// per Riccati step. PERF.md has the times, the vote counts and the
// -Xptxas -v report.
//
// Numerics: f32, compiled without -use_fast_math (cosf/sinf are the
// accurate versions, division and sqrt IEEE-rounded); rsqrtf and nvcc's
// default FMA contraction move results by a few ulp from the plain
// PyTorch version, which the tests' tolerances state. The result does not
// depend on G: the per-example arithmetic and the votes are the same.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ilqr_fused.cuh"

namespace cg = cooperative_groups;

namespace dilqr {

constexpr int kTile = 1024;  // examples a tile: the JAX kernel's base tile

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
  float* work;  // scratch: 3 x [T, NX + NU, Bp] trajectories, then K [T, NU*NX, Bp], k [T, NU, Bp]
  float* bx;    // [T, NX, Bp] out: best x (zero-initialized by the wrapper)
  float* bu;    // [T, NU, Bp] out: best u (zero-initialized by the wrapper)
  float* bc;    // [Bp]        out: best cost
  float* bdu;   // [Bp]        out: full_du_norm of the best iterate
  int* iters;   // [Bp / 1024] out: iterations each tile ran
  long long* probe;  // [Bp / 1024, 3] out, or null: per tile the votes, the
                     // cycles in votes and the cycles of the whole kernel
                     // (rank 0, thread 0)
  int* smids;        // [blocks] out, or null: the SM each block ran on
};

// dynamic shared memory of a block of EX examples
template <class Env, int NU>
constexpr size_t smem_bytes(int EX) {
  return NU == 1 ? 0 : sizeof(float) * BoxStepLayout<Env, NU>::kFloats * EX;
}

template <class Env, int NU, int EX>
__global__ void __launch_bounds__(EX) ilqr_fused_kernel(const Args a) {
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
  extern __shared__ float box_store[];  // n_ctrl > 1: V, Q, F [entry][example]

  Env env;
  env.load(a.params);
  float lo[NU], hi[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) {
    lo[r] = a.lo[r];
    hi[r] = a.hi[r];
  }

  float x0[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = a.x_init[i * Bp + b];

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
    float v[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) v[i] = 0.0f;
    // V in registers for n_ctrl == 1; the rocket's is in shared memory
    [[maybe_unused]] float V[NU == 1 ? NX : 1][NU == 1 ? NX : 1];
    if constexpr (NU == 1) {
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
      const float* C = Cat(t);
      const float* c = cat(t);

      if constexpr (NU == 1) {
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

        // exact closed-form 1-D box-QP in delta space
        const float ut = tau[NX];
        const float H = Q[NX][NX];
        const float qu = q[NX];
        const float lb = lo[0] - ut, ub = hi[0] - ut;
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
        // V, Q, F in shared memory; the step is riccati_box_step
        float warm[NU], K[NU][NX], kt[NU];
        if (t < T - 1) {
          // warm start with the next step's k of this sweep
#pragma unroll
          for (int r = 0; r < NU; ++r) warm[r] = kg[(t + 1) * sU + r * Bp + b];
        }
        riccati_box_step<Env, NU>(env, t == T - 1, tau, C, c, lo, hi, warm, a.pnqp_iter, vote,
                                  box_store + threadIdx.x, EX, v, K, kt);
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
            const float new_u = clip(kdx + urt + alpha * kg[t * sU + r * Bp + b], lo[r], hi[r]);
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

// The kernel of (Env, NU) for a tile of G blocks, with its launch shape.
template <class Env, int NU, int EX>
struct Launch {
  static cudaError_t configure(int G, size_t smem) {
    auto kernel = ilqr_fused_kernel<Env, NU, EX>;
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
    e = cudaLaunchKernelEx(&cfg, ilqr_fused_kernel<Env, NU, EX>, a);
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
    auto kernel = ilqr_fused_kernel<Env, NU, EX>;
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

// Calls f(Launch<Env, NU, 1024 / G>{}) for the env and the cluster size G
// in {8, 16}: blocks of 128 or 64 threads (the rocket's shared memory caps
// a block at 128 examples; at 256 threads ptxas gave the pendulum 64
// registers and a stack). Anything else is cudaErrorInvalidValue.
template <int EX, class F>
cudaError_t dispatch_env(int env, F f) {
  switch (env) {
    case ENV_CARTPOLE:
      return f(Launch<Cartpole, 1, EX>{});
    case ENV_PENDULUM:
      return f(Launch<Pendulum, 1, EX>{});
    case ENV_ROCKET:
      return f(Launch<Rocket, 3, EX>{});
    default:
      return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t dispatch(int env, int G, F f) {
  if (G == 8) return dispatch_env<kTile / 8>(env, f);
  if (G == 16) return dispatch_env<kTile / 16>(env, f);
  return cudaErrorInvalidValue;
}

}  // namespace dilqr

// lo/hi: host arrays of kMaxNu floats (the env's bounds first, padded),
// copied into the kernel's arguments. cluster: the blocks of one
// 1024-example tile (dispatch). probe, smids: null, or the per-tile vote
// counts and clock cycles and the per-block SM ids, for measurement.
extern "C" int dilqr_ilqr_fused(int env, int T, int Bp, int Tc, const float* params,
                                const float* x_init, const float* Cs, const float* cs,
                                const float* u_init, const float* lo, const float* hi,
                                int lqr_iter, float eps, float ls_decay, int max_ls_iter,
                                float best_cost_eps, int not_improved_lim, int pnqp_iter,
                                int cluster, float* work, float* bx, float* bu, float* bc,
                                float* bdu, int* iters, long long* probe, int* smids,
                                void* stream) {
  if (Bp <= 0 || Bp % dilqr::kTile != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  dilqr::Args a{T, Bp, Tc, params, x_init, Cs, cs, u_init, {}, {},
                lqr_iter, max_ls_iter, not_improved_lim, pnqp_iter, eps, ls_decay,
                best_cost_eps, work, bx, bu, bc, bdu, iters, probe, smids};
  for (int r = 0; r < dilqr::kMaxNu; ++r) {
    a.lo[r] = lo[r];
    a.hi[r] = hi[r];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dilqr::dispatch(env, cluster, [&](auto l) { return l.run(a, cluster, st); });
}

// out[5]: cudaOccupancyMaxActiveClusters, registers, local bytes a thread,
// static and dynamic shared bytes a block of the (env, cluster) kernel.
extern "C" int dilqr_ilqr_fused_info(int env, int cluster, int* out) {
  return (int)dilqr::dispatch(env, cluster, [&](auto l) { return l.info(cluster, out); });
}
