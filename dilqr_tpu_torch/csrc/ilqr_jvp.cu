// The whole-solve batched iLQR kernel (ilqr_kernel.cuh) with the Jacobian
// by forward mode: JvpJac<Env, Clamped> (ilqr_fused.cuh) evaluates the
// env's step on Duals (dual.cuh) once per column of [dx'/dx | dx'/du], as
// the JAX kernel's jvp sweep does wherever it has no hand-derived Jacobian
// (`lin_at`, dilqr_tpu/ops/pallas/ilqr_fused.py:1258-1266, taken at
// :1956-1966):
//  * GradMethod.AUTO_DIFF on every env with device code (Clamped: the
//    clamped step, so a saturated control's column is 0);
//  * the complex pendulum (PendulumComplex) and the rocket with
//    normalize_quat=True (RocketNorm), which have no hand Jacobian, under
//    ANALYTIC too (the un-clamped physics);
//  * the slew-rate wrapper of each, Passthrough<JvpJac<Env, Clamped>>.
//
// One library per (env, method), as ilqr_lindx.cu is one per shape:
// ops/cuda/build.py compiles this file at first use with
// -DDILQR_JVP_ENV=<device env id> -DDILQR_JVP_CLAMPED=<0 | 1> into its own
// library in dilqr_tpu_torch/_build/, so ilqr_fused.cu keeps its
// instantiations and its compile time. Each library has the cluster sizes
// whose shared memory fits (G = 8 and 16) and both cost forms (the slew-rate wrappers the per-example one
// only), behind the C interface of ilqr_fused.cu.
//
// What bounds it is what bounds the kernel: a serial recursion per example,
// now with n step evaluations on Duals at each Riccati step in place of the
// hand Jacobian -- operations, not bytes.
// Built with -DDILQR_CALLABLE_COST=1 beside a generated callable cost
// (callable_cost.cuh), the library solves the env with that cost instead.
#include <type_traits>

#include "callable_cost.cuh"

#if !defined(DILQR_JVP_ENV) || !defined(DILQR_JVP_CLAMPED)
#error "build with -DDILQR_JVP_ENV=<device env id 0..9> -DDILQR_JVP_CLAMPED=<0|1>"
#endif

namespace dilqr {

// the base env of each device env id, and whether the id is its slew-rate
// wrapper
template <int ID>
struct JvpBase;
template <>
struct JvpBase<ENV_CARTPOLE> { using type = Cartpole; static constexpr bool slew = false; };
template <>
struct JvpBase<ENV_PENDULUM> { using type = Pendulum; static constexpr bool slew = false; };
template <>
struct JvpBase<ENV_ROCKET> { using type = Rocket; static constexpr bool slew = false; };
template <>
struct JvpBase<ENV_CARTPOLE_SLEW> { using type = Cartpole; static constexpr bool slew = true; };
template <>
struct JvpBase<ENV_PENDULUM_SLEW> { using type = Pendulum; static constexpr bool slew = true; };
template <>
struct JvpBase<ENV_ROCKET_SLEW> { using type = Rocket; static constexpr bool slew = true; };
template <>
struct JvpBase<ENV_PENDULUM_COMPLEX> {
  using type = PendulumComplex;
  static constexpr bool slew = false;
};
template <>
struct JvpBase<ENV_ROCKET_NORM> { using type = RocketNorm; static constexpr bool slew = false; };
template <>
struct JvpBase<ENV_PENDULUM_COMPLEX_SLEW> {
  using type = PendulumComplex;
  static constexpr bool slew = true;
};
template <>
struct JvpBase<ENV_ROCKET_NORM_SLEW> {
  using type = RocketNorm;
  static constexpr bool slew = true;
};

constexpr int kEnvId = DILQR_JVP_ENV;
constexpr bool kClamped = DILQR_JVP_CLAMPED != 0;
using Base = JvpBase<kEnvId>;
using Jvp = JvpJac<typename Base::type, kClamped>;
using Env = std::conditional_t<Base::slew, Passthrough<Jvp>, Jvp>;

// f(Launch<Env, NU, 1024 / G, LANES>{}) for G in {8, 16} and the cost form
// where it fits; a slew-rate wrapper takes the per-example cost only (the
// wrapper expands an example-invariant one)
template <int EX, class F>
cudaError_t dispatch_ex(int lanes, F f) {
  if constexpr (kCallableCost) {
    if (lanes || Base::slew) return cudaErrorInvalidValue;
    return launch_if_fits<Env, Env::NU, EX, false, KernelCost>(f);
  } else {
    if (lanes) return launch_if_fits<Env, Env::NU, EX, true>(f);
    if constexpr (Base::slew) {
      return cudaErrorInvalidValue;
    } else {
      return launch_if_fits<Env, Env::NU, EX, false>(f);
    }
  }
}

template <class F>
cudaError_t dispatch_jvp(int lanes, int G, F f) {
  if (G == 8) return dispatch_ex<kTile / 8>(lanes, f);
  if (G == 16) return dispatch_ex<kTile / 16>(lanes, f);
  return cudaErrorInvalidValue;
}

}  // namespace dilqr

// The arguments of dilqr_ilqr_fused in ilqr_fused.cu; env must be this
// library's device env id.
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
  if (env != dilqr::kEnvId) return (int)cudaErrorInvalidValue;
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
  return (int)dilqr::dispatch_jvp(cost_lanes, cluster,
                                  [&](auto l) { return l.run(a, cluster, st); });
}

// out[5] as ilqr_fused.cu's dilqr_ilqr_fused_info, for this library's
// kernel at the cost form and cluster size
extern "C" int dilqr_ilqr_fused_info(int env, int cost_lanes, int cluster, int* out) {
  if (env != dilqr::kEnvId) return (int)cudaErrorInvalidValue;
  return (int)dilqr::dispatch_jvp(cost_lanes, cluster,
                                  [&](auto l) { return l.info(cluster, out); });
}
