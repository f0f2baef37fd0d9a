// Module-KKT VJP kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_kkt_kernel`
// (dilqr_tpu/ops/pallas/kkt_fused.py:173) and `_kkt_stream_kernel`
// (kkt_fused.py:306), both called through `make_kkt_vjp_pallas` (:431,
// `pallas_call` :545), together with the dF/df/dC assembly that the JAX
// wrapper leaves to XLA (:561-572): the backward of every GMRES iteration
// of the IFT gradient and the one KKT-mode VJP. One launch maps a
// cotangent (g_x, g_u) to dF, df and, in full mode, dx_init, dC and dc.
//
// Design. An example is a team of L lanes (L >= n_state + n_ctrl, a power
// of two: 8 for the cartpole's (5,1) and the slew rate's (6,1), 16 for the
// rocket's (13,3)); lane i owns row i of V, F, VF and Q and column i of K,
// so a lane keeps one row of each matrix and the three recursions run as
// phases between team barriers (kkt_example in kkt_fused.cuh). Teams are
// independent: no block-wide barrier, and the result does not depend on how
// many teams a block holds (64, 128 or 256 threads; 128 by default). At
// B=4096 the cartpole runs 1024 warps, about 8 an SM, where one thread an
// example ran 128. Each step's input slab (C triangle, F, mask, adjoint
// offset, tau; one contiguous run per example) is staged into a ring in the
// team's shared memory two steps ahead of its use with cp.async, so device
// memory latency leaves the serial chain; K, k and dtau stay in the team's
// shared memory while the block fits in half an SM's (any longer horizon
// keeps them in a global store, same order, same bits). dF, df, dC, dc are
// written once, each team's block of consecutive floats by consecutive
// lanes.
//
// What bounds it. At the cartpole, B=4096, T=20, an "Ff" call must move
// about 2,000 floats an example (a step's C triangle 21, cotangent 6, mask 1,
// adjoint offset 5 and tau 6 read, F 30 for T-1 steps; dF 30 and df 5
// written for T-1 steps; chip_smoke.py kkt_work) for about 1,300 FLOP a
// step: under 1 FLOP a byte, so bytes bound it, at about 10 us at 3.35
// TB/s. What sets the time is one team's serial chain of 3T steps, the same
// at B=256 and B=4096: each phase issues its shared-memory loads one warp
// instruction at a time. So the inner loops run to L with no bound check
// (zero rows and entries stand in for what lies past n_state, see
// kkt_fused.cuh), F and V F are read four floats an instruction from
// 16-byte aligned rows, and the one-control gains take a reciprocal, not
// an IEEE division (PERF.md has the measurements).
//
// Numerics: f32, no -use_fast_math; nvcc's FMA contraction moves results
// by a few ulp from the plain PyTorch version (kkt_fused_reference).
#include <cuda_runtime.h>

#include "kkt_fused.cuh"

namespace dilqr {

// half an SM's shared memory: the K/k/dtau store stays in shared memory
// while a block needs no more, so two blocks fit an SM
constexpr int kKktSmemCap = 232448 / 2;

template <int NU, int L>
__global__ void __launch_bounds__(256, 1) kkt_fused_kernel(const KktArgs a, const KktLayout y) {
  extern __shared__ __align__(16) float smem[];
  const int team = threadIdx.x / L;
  const int b = blockIdx.x * (blockDim.x / L) + team;
  if (b >= a.B) return;  // the whole team leaves together
  DeviceTeam<KktLane<NU, L>, L> tm{(int)(threadIdx.x & (L - 1)), {}};
  kkt_example<NU, L>(a, y, b, smem + (size_t)team * y.team, tm);
}

// The launch plan of (NU, L): out = {L, teams a block, shared bytes a block,
// 1 if K/k/dtau go to the global store, store floats a step, slab floats}.
template <int NU, int L>
int plan(int nx, int T, int block, int force_global, int* out) {
  if (block % L != 0 || block < L || block > 256) return (int)cudaErrorInvalidValue;
  const int teams = block / L;
  KktLayout y = kkt_layout<NU, L>(nx, T, true);
  const bool global = force_global || (size_t)teams * y.team * 4 > (size_t)kKktSmemCap;
  if (global) y = kkt_layout<NU, L>(nx, T, false);
  out[0] = L;
  out[1] = teams;
  out[2] = teams * y.team * 4;
  out[3] = global;
  out[4] = y.KS;
  out[5] = y.S;
  return 0;
}

template <int NU, int L>
int launch(const KktArgs& a, int nx, int block, int force_global, cudaStream_t st) {
  int p[6];
  int e = plan<NU, L>(nx, a.T, block, force_global, p);
  if (e) return e;
  if (p[3] && !a.store) return (int)cudaErrorInvalidValue;
  const KktLayout y = kkt_layout<NU, L>(nx, a.T, !p[3]);
  KktArgs g = a;
  if (!p[3]) g.store = nullptr;
  if (p[2] > 48 * 1024) {  // more than 48 KB a block needs the attribute, per device
    e = (int)cudaFuncSetAttribute(kkt_fused_kernel<NU, L>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, p[2]);
    if (e) return e;
  }
  const dim3 grid((a.B + p[1] - 1) / p[1]);
  kkt_fused_kernel<NU, L><<<grid, block, p[2], st>>>(g, y);
  return (int)cudaGetLastError();
}

}  // namespace dilqr

// out[6]: see dilqr::plan. block: threads a block (64, 128 or 256).
extern "C" int dilqr_kkt_plan(int nx, int nu, int T, int block, int force_global, int* out) {
  const int r = dilqr::kkt_dispatch(nx, nu, [&](auto s) {
    return dilqr::plan<decltype(s)::NU, decltype(s)::L>(nx, T, block, force_global, out);
  });
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}

// One VJP. dxi, dC, dc null: "Ff" mode. store: [T, B, KS] floats, used
// when the plan says so (null otherwise).
extern "C" int dilqr_kkt_fused(int nx, int nu, int T, int B, int block, int force_global,
                               const float* slab, const float* gx, long long gxt, long long gxb,
                               const float* gu, long long gut, long long gub, float* dF,
                               float* df, float* dxi, float* dC, float* dc, float* store,
                               void* stream) {
  if (B <= 0 || T < 2) return (int)cudaErrorInvalidValue;
  if ((dxi == nullptr) != (dC == nullptr) || (dC == nullptr) != (dc == nullptr))
    return (int)cudaErrorInvalidValue;
  const dilqr::KktArgs a{T, B, slab, gx, gxt, gxb, gu, gut, gub, dF, df, dxi, dC, dc, store};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = dilqr::kkt_dispatch(nx, nu, [&](auto s) {
    return dilqr::launch<decltype(s)::NU, decltype(s)::L>(a, nx, block, force_global, st);
  });
  return r < 0 ? (int)cudaErrorInvalidValue : r;
}
