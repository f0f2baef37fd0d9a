// Whole-solve batched iLQR kernel for Hopper (sm_90a): the instantiations
// for the envs with device code (cartpole, the simple pendulum, the rocket
// with normalize_quat=False and the slew-rate wrapper Passthrough<Env> of
// each) and their C interface. The kernel, its design and what bounds it
// are in ilqr_kernel.cuh; a LinDx problem's instantiation is ilqr_lindx.cu.
// Built as it is, the library has the QuadCost forms; built with
// -DDILQR_CALLABLE_COST=1 beside a generated callable cost
// (callable_cost.cuh, ops/cuda/ilqr_fused.with_cost), the base envs'
// instantiations for that cost and nothing else.
#include "callable_cost.cuh"

namespace dilqr {

// the env's instantiations for both cost forms, or for the callable cost
template <class Env, int NU, int EX, class F>
cudaError_t launch_either(int lanes, F f) {
  if constexpr (kCallableCost) {
    return lanes ? cudaErrorInvalidValue : launch_if_fits<Env, NU, EX, false, KernelCost>(f);
  } else {
    return lanes ? launch_if_fits<Env, NU, EX, true>(f) : launch_if_fits<Env, NU, EX, false>(f);
  }
}

// a slew-rate wrapper's instantiation (the per-example cost only)
template <class Env, int NU, int EX, class F>
cudaError_t launch_slew(int lanes, F f) {
  if constexpr (kCallableCost) {
    return cudaErrorInvalidValue;
  } else {
    return lanes ? launch_if_fits<Env, NU, EX, true>(f) : cudaErrorInvalidValue;
  }
}

// Calls f(Launch<Env, NU, 1024 / G, LANES>{}) for the env, the cost form
// and the cluster size G in {8, 16}: blocks of 128 or 64 threads (the
// slew-rate rocket's shared memory, 1,280 bytes an example, caps a block at
// 128 examples; at 256 threads ptxas gave the pendulum 64 registers and a
// stack). The slew-rate wrappers take the per-example cost only (the
// wrapper expands an example-invariant one). Anything else is
// cudaErrorInvalidValue.
template <int EX, class F>
cudaError_t dispatch_env(int env, int lanes, F f) {
  switch (env) {
    case ENV_CARTPOLE:
      return launch_either<Cartpole, 1, EX>(lanes, f);
    case ENV_PENDULUM:
      return launch_either<Pendulum, 1, EX>(lanes, f);
    case ENV_ROCKET:
      return launch_either<Rocket, 3, EX>(lanes, f);
    case ENV_CARTPOLE_SLEW:
      return launch_slew<Passthrough<Cartpole>, 1, EX>(lanes, f);
    case ENV_PENDULUM_SLEW:
      return launch_slew<Passthrough<Pendulum>, 1, EX>(lanes, f);
    case ENV_ROCKET_SLEW:
      return launch_slew<Passthrough<Rocket>, 3, EX>(lanes, f);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t dispatch(int env, int lanes, int G, F f) {
  if (G == 8) return dispatch_env<kTile / 8>(env, lanes, f);
  if (G == 16) return dispatch_env<kTile / 16>(env, lanes, f);
  return cudaErrorInvalidValue;
}

}  // namespace dilqr

// cost_lanes: 0 for the example-invariant cost C [Tc, N*N], c [Tc, N]; 1
// for the per-example C [T, N*N, Bp], c [T, N, Bp]. A callable-cost
// library takes 0, its cost's params as C (null for none) and no c. lo/hi: host arrays of
// kMaxNu floats (the env's bounds first, padded), copied into the kernel's
// arguments; lb/ub: [T, NU, Bp] per-time and per-example bounds, or null
// for lo/hi. uz: the u_zero_I mask [T, NU, Bp] as bytes, or null;
// uz_free: the solve is unboxed (its Riccati takes the mask's free
// subspace). has_du/du: the static delta_u. cluster: the blocks of one
// 1024-example tile (dispatch). probe, smids: null, or the per-tile vote
// counts and clock cycles and the per-block SM ids, for measurement.
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
  return (int)dilqr::dispatch(env, cost_lanes, cluster,
                              [&](auto l) { return l.run(a, cluster, st); });
}

// out[5]: cudaOccupancyMaxActiveClusters, registers, local bytes a thread,
// static and dynamic shared bytes a block of the (env, cost form, cluster)
// kernel.
extern "C" int dilqr_ilqr_fused_info(int env, int cost_lanes, int cluster, int* out) {
  return (int)dilqr::dispatch(env, cost_lanes, cluster,
                              [&](auto l) { return l.info(cluster, out); });
}
