// The whole-solve batched iLQR kernel (ilqr_kernel.cuh) for the learned
// model with its widths fixed, Mlp<NX, NU, ACT, Residual, H...>
// (ilqr_fused.cuh): the counterpart of the JAX kernel on an MLP whose
// weights it flattens into its scalars (`_flatten_pytree_params`,
// dilqr_tpu/ops/pallas/ilqr_fused.py:405-428; the step `step_scalars`,
// dilqr_tpu/models/nn_dynamics.py:92-112), past JAX's 256 weights for a net
// of one hidden layer (its last hidden layer is streamed: Mlp). The step has
// no clamp, so ANALYTIC and AUTO_DIFF differentiate the same function and
// one library serves both: a net of one hidden layer takes its hand
// Jacobian (Mlp::jac, the reference's grad_input; ilqr_fused.mlp_hand), a
// deeper net JvpJac's (the jvp sweep `lin_at`, :1258-1266). Its slew-rate
// wrapper is Passthrough<> of either.
//
// One library per (shape, activation, residual, slew rate, cost form), as
// ilqr_lindx.cu is one per shape: ops/cuda/build.py compiles this file at
// first use with -DDILQR_MLP_NX=<n_state> -DDILQR_MLP_NU=<n_ctrl>
// -DDILQR_MLP_HIDDEN=<widths joined by x, as 16 or 6x6; absent for none>
// -DDILQR_MLP_ACT=<MlpAct> -DDILQR_MLP_RESIDUAL=<0|1> -DDILQR_MLP_SLEW=<0|1>
// -DDILQR_MLP_LANES=<0|1> into its own library in dilqr_tpu_torch/_build/
// (ops/cuda/ilqr_fused.mlp_spec). Each has the cluster sizes whose shared
// memory fits (ilqr_fused.mlp_clusters), behind the C interface of
// ilqr_fused.cu; `env` must be ENV_MLP, or ENV_MLP_SLEW for the wrapper,
// and `params` the flat weights [NP] on the card.
//
// What bounds it is what bounds the kernel: a serial recursion per example,
// here with the Jacobian at each Riccati step as one pass over the hidden
// units (the hand one) or n = NX + NU evaluations of the MLP on Duals (the
// values once, a tangent's products per column) -- operations, not bytes.
// The weights are read in place at each use (Mlp).
#include <type_traits>
#include <utility>

#include "callable_cost.cuh"

#if !defined(DILQR_MLP_NX) || !defined(DILQR_MLP_NU) || !defined(DILQR_MLP_ACT) || \
    !defined(DILQR_MLP_RESIDUAL) || !defined(DILQR_MLP_SLEW) || !defined(DILQR_MLP_LANES)
#error "build with -DDILQR_MLP_NX, _NU, _ACT, _RESIDUAL, _SLEW, _LANES (and _HIDDEN)"
#endif

namespace dilqr {

// The hidden widths arrive as one pp-number, 6x6 (nvcc splits a -D value
// at its commas), spelled out by the preprocessor and read at compile time.
#define DILQR_SPELL2(x) #x
#define DILQR_SPELL(x) DILQR_SPELL2(x)
#ifdef DILQR_MLP_HIDDEN
constexpr char kHidden[] = DILQR_SPELL(DILQR_MLP_HIDDEN);
#else
constexpr char kHidden[] = "";
#endif
constexpr int hidden_count() {
  int n = kHidden[0] ? 1 : 0;
  for (const char* c = kHidden; *c; ++c) n += *c == 'x';
  return n;
}
constexpr int hidden_at(int i) {
  int k = 0, v = 0;
  for (const char* c = kHidden; *c; ++c) {
    if (*c == 'x') {
      if (k++ == i) return v;
      v = 0;
    } else {
      v = 10 * v + (*c - '0');
    }
  }
  return v;
}
template <size_t... I>
Mlp<DILQR_MLP_NX, DILQR_MLP_NU, DILQR_MLP_ACT, DILQR_MLP_RESIDUAL != 0, hidden_at(I)...> net_of(
    std::index_sequence<I...>);
using Net = decltype(net_of(std::make_index_sequence<hidden_count()>{}));
static_assert(Net::NU >= 1 && Net::NU <= kMaxNu, "1 <= n_ctrl <= kMaxNu");
constexpr bool kSlew = DILQR_MLP_SLEW != 0;
constexpr bool kLanes = DILQR_MLP_LANES != 0;
static_assert(kLanes || !kSlew, "the slew-rate wrapper takes the per-example cost only");
// the hand Jacobian for one hidden layer (ilqr_fused.mlp_hand)
constexpr bool kHand = Net::kLayers == 2;
constexpr int kEnvId = kSlew ? ENV_MLP_SLEW : ENV_MLP;
using Base = std::conditional_t<kHand, Net, JvpJac<Net, false>>;
using Env = std::conditional_t<kSlew, Passthrough<Base>, Base>;

// f(Launch<Env, NU, 1024 / G, kLanes>{}) for G in {8, 16} where it fits
template <class F>
cudaError_t dispatch_mlp(int G, F f) {
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
  if (env != dilqr::kEnvId || cost_lanes != (int)dilqr::kLanes || params == nullptr)
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
  return (int)dilqr::dispatch_mlp(cluster, [&](auto l) { return l.run(a, cluster, st); });
}

// out[5] as ilqr_fused.cu's dilqr_ilqr_fused_info, for this library's
// kernel at the cluster size
extern "C" int dilqr_ilqr_fused_info(int env, int cost_lanes, int cluster, int* out) {
  if (env != dilqr::kEnvId || cost_lanes != (int)dilqr::kLanes) return (int)cudaErrorInvalidValue;
  return (int)dilqr::dispatch_mlp(cluster, [&](auto l) { return l.info(cluster, out); });
}
