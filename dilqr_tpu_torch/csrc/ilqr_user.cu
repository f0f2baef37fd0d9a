// The whole-solve batched iLQR kernel (ilqr_kernel.cuh) for a user's own
// model: a Dynamics with neither device code nor fixed MLP widths, whose
// step and linearization point ops/cuda/traced.py traces with torch.fx and
// generates as straight-line C++ (traced::Model in the header
// dilqr_traced.cuh). The counterpart of the JAX kernel on a model that
// passes `lane_compatible` (dilqr_tpu/ops/pallas/ilqr_fused.py:357-388;
// dispatch at dilqr_tpu/core/ilqr.py:206-214), whose Jacobian is then the
// jvp sweep `lin_at` (:1258-1266): here JvpJac<Traced<traced::Model>,
// Clamped> (ilqr_fused.cuh), the clamped step under GradMethod.AUTO_DIFF
// (Clamped) and the model's linearize_point under ANALYTIC.
//
// One library per traced model, method and cost form, built at first use:
// ops/cuda/build.py writes the generated header into the library's own
// directory under dilqr_tpu_torch/_build/ and compiles this file with
// -DDILQR_USER_CLAMPED=<0|1> -DDILQR_USER_LANES=<0|1> and, for a callable
// cost (traced::Cost in the same header), -DDILQR_CALLABLE_COST=1
// (ops/cuda/ilqr_fused.user_spec). The header's text is part of the
// library's hash and name. Each library has the cluster sizes whose shared
// memory fits (G = 8 and 16, as a LinDx shape's: ilqr_fused.lindx_clusters),
// behind the C interface of ilqr_fused.cu; `env` must be ENV_TRACED and
// `params` the model's flat params [NP] on the card.
//
// What bounds it is what bounds the kernel: a serial recursion per
// example, here with the Jacobian as n = NX + NU evaluations of the
// generated step on Duals at each Riccati step and, for a callable cost,
// n (n + 1) / 2 evaluations of the cost on nested Duals -- operations, not
// bytes. traced.py counts the generated code's operations, from which
// chip_smoke.py computes the bound.
#include "callable_cost.cuh"
#include "dilqr_traced.cuh"

#if !defined(DILQR_USER_CLAMPED) || !defined(DILQR_USER_LANES)
#error "build with -DDILQR_USER_CLAMPED=<0|1> -DDILQR_USER_LANES=<0|1> (and the generated header)"
#endif

namespace dilqr {

using Model = Traced<traced::Model>;
using Env = JvpJac<Model, DILQR_USER_CLAMPED != 0>;
constexpr bool kLanes = DILQR_USER_LANES != 0;
static_assert(Env::NU >= 1 && Env::NU <= kMaxNu, "1 <= n_ctrl <= kMaxNu");
static_assert(!(kLanes && kCallableCost), "a callable cost has no per-example form");

// f(Launch<Env, NU, 1024 / G, kLanes, KernelCost>{}) for G in {8, 16} where
// it fits
template <class F>
cudaError_t dispatch_user(int G, F f) {
  if (G == 8) return launch_if_fits<Env, Env::NU, kTile / 8, kLanes, KernelCost>(f);
  if (G == 16) return launch_if_fits<Env, Env::NU, kTile / 16, kLanes, KernelCost>(f);
  return cudaErrorInvalidValue;
}

}  // namespace dilqr

// The arguments of dilqr_ilqr_fused in ilqr_fused.cu; env and cost_lanes
// must be this library's.
extern "C" int dilqr_ilqr_fused(int env, int T, int Bp, int cost_lanes, int Tc,
                                const float* params, const float* x_init, const float* C,
                                const float* c, const float* u_init, const float* lo,
                                const float* hi, const float* lb, const float* ub,
                                const unsigned char* uz, int uz_free, int has_du, float du,
                                int lqr_iter, float eps, float ls_decay, int max_ls_iter,
                                float best_cost_eps, int not_improved_lim, int pnqp_iter,
                                int cluster, float* work, float* bx, float* bu, float* bc,
                                float* bdu, int* iters, long long* probe, int* smids,
                                void* stream) {
  if (env != dilqr::ENV_TRACED || cost_lanes != (int)dilqr::kLanes)
    return (int)cudaErrorInvalidValue;
  if (Bp <= 0 || Bp % dilqr::kTile != 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if ((lb == nullptr) != (ub == nullptr) || (uz_free && uz == nullptr))
    return (int)cudaErrorInvalidValue;
  dilqr::Args a{T, Bp, Tc, params, x_init, C, c, u_init, {}, {}, lb, ub, uz,
                uz_free, has_du, du, lqr_iter, max_ls_iter, not_improved_lim, pnqp_iter, eps,
                ls_decay, best_cost_eps, work, bx, bu, bc, bdu, iters, probe, smids,
                nullptr, nullptr};
  for (int r = 0; r < dilqr::kMaxNu; ++r) {
    a.lo[r] = lo[r];
    a.hi[r] = hi[r];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dilqr::dispatch_user(cluster, [&](auto l) { return l.run(a, cluster, st); });
}

// out[5] as ilqr_fused.cu's dilqr_ilqr_fused_info, for this library's
// kernel at the cluster size
extern "C" int dilqr_ilqr_fused_info(int env, int cost_lanes, int cluster, int* out) {
  if (env != dilqr::ENV_TRACED || cost_lanes != (int)dilqr::kLanes)
    return (int)cudaErrorInvalidValue;
  return (int)dilqr::dispatch_user(cluster, [&](auto l) { return l.info(cluster, out); });
}
