// The whole-solve batched iLQR kernel (ilqr_kernel.cuh) for a time-varying
// affine (LQR) problem, LinDx<NX, NU> (ilqr_fused.cuh): F and f are inputs
// the kernel reads per step instead of linearizing, as the JAX kernel
// reads its F/f lane inputs (dilqr_tpu/ops/pallas/ilqr_fused.py:1166-1176,
// :1269-1270, :1841-1856).
//
// One library per shape and cost form, as JAX compiles its kernel per
// (n_state, n_ctrl): ops/cuda/build.py compiles this file at first use
// with -DDILQR_LINDX_NX=<n_state> -DDILQR_LINDX_NU=<n_ctrl>
// -DDILQR_LINDX_LANES=<0 | 1> (the example-invariant or the per-example
// cost) into its own library in dilqr_tpu_torch/_build/. Each has the
// block sizes whose shared memory fits: 128 examples a block (a tile of
// G = 8 blocks) while the Riccati step's store (BoxStepLayout: V, Q and F,
// or past 225 floats V and Q without Quu, F copied from the data into the
// launch's scratch) takes at most 454 floats an example, and 64 (G = 16)
// always. One control with at most kRegisterNx states keeps them in
// registers instead.
//
// What bounds it is what bounds the kernel (ilqr_kernel.cuh): a serial
// recursion per example, T steps x lqr_iter iterations, little data; a
// sweep reads F and f once more than a physics env's solve, which the L2
// holds at B=4096.
#include "callable_cost.cuh"

#if !defined(DILQR_LINDX_NX) || !defined(DILQR_LINDX_NU) || !defined(DILQR_LINDX_LANES)
#error "build with -DDILQR_LINDX_NX=<n_state> -DDILQR_LINDX_NU=<n_ctrl> -DDILQR_LINDX_LANES=<0|1>"
#endif

namespace dilqr {

using Lin = LinDx<DILQR_LINDX_NX, DILQR_LINDX_NU>;
static_assert(Lin::NU >= 1 && Lin::NU <= kMaxNu, "1 <= n_ctrl <= kMaxNu");
constexpr bool kLanes = DILQR_LINDX_LANES != 0;

// f(Launch<Lin, NU, 1024 / G, kLanes>{}) for G in {8, 16} where it fits
template <class F>
cudaError_t dispatch_lindx(int G, F f) {
  if (G == 8) return launch_if_fits<Lin, Lin::NU, kTile / 8, kLanes, KernelCost>(f);
  if (G == 16) return launch_if_fits<Lin, Lin::NU, kTile / 16, kLanes, KernelCost>(f);
  return cudaErrorInvalidValue;
}

}  // namespace dilqr

// The arguments of dilqr_ilqr_fused (ilqr_fused.cu), with the shape and
// cost form in place of the env and its params: nx, nu and cost_lanes must
// be this library's. F: [T-1, nx*(nx+nu), Bp]; f: [T-1, nx, Bp] or null.
extern "C" int dilqr_ilqr_lindx(int nx, int nu, int T, int Bp, int cost_lanes, int Tc,
                                const float* F, const float* f, const float* x_init,
                                const float* C, const float* c, const float* u_init,
                                const float* lo, const float* hi, const float* lb,
                                const float* ub, const unsigned char* uz, int uz_free,
                                int has_du, float du, int lqr_iter, float eps, float ls_decay,
                                int max_ls_iter, float best_cost_eps, int not_improved_lim,
                                int pnqp_iter, int cluster, float* work, float* bx, float* bu,
                                float* bc, float* bdu, int* iters, long long* probe, int* smids,
                                void* stream) {
  if (nx != dilqr::Lin::NX || nu != dilqr::Lin::NU || cost_lanes != (int)dilqr::kLanes)
    return (int)cudaErrorInvalidValue;
  if (Bp <= 0 || Bp % dilqr::kTile != 0 || T <= 0 || (T > 1 && F == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((lb == nullptr) != (ub == nullptr) || (uz_free && uz == nullptr))
    return (int)cudaErrorInvalidValue;
  dilqr::Args a{T, Bp, Tc, nullptr, x_init, C, c, u_init, {}, {}, lb, ub, uz,
                uz_free, has_du, du, lqr_iter, max_ls_iter, not_improved_lim, pnqp_iter, eps,
                ls_decay, best_cost_eps, work, bx, bu, bc, bdu, iters, probe, smids, F, f};
  for (int r = 0; r < dilqr::kMaxNu; ++r) {
    a.lo[r] = lo[r];
    a.hi[r] = hi[r];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dilqr::dispatch_lindx(cluster, [&](auto l) { return l.run(a, cluster, st); });
}

// out[5] as dilqr_ilqr_fused_info's, for this library's kernel at the
// cluster size
extern "C" int dilqr_ilqr_lindx_info(int nx, int nu, int cost_lanes, int cluster, int* out) {
  if (nx != dilqr::Lin::NX || nu != dilqr::Lin::NU || cost_lanes != (int)dilqr::kLanes)
    return (int)cudaErrorInvalidValue;
  return (int)dilqr::dispatch_lindx(cluster, [&](auto l) { return l.info(cluster, out); });
}
