// Reverse Riccati kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_riccati_kernel`
// (dilqr_tpu/ops/pallas/riccati_fused.py:57, called through
// `lqr_backward_pallas` :161): the T-step reverse Riccati recursion of one
// control, closed-form QP, in the free, box and zero (u_zero_I) gain modes,
// for any n_state. It is the Riccati backward of every iteration of the
// plain iLQR loop for the solves the whole-solve kernel refuses (the MLP
// dynamics model, the slew-rate augmentation, the affine model, u_zero_I,
// delta_u), and the auxiliary LQR of the KKT backward where the KKT kernel
// has no instantiation.
//
// Design. An example is a team of L lanes (L a power of two >= n_state + 1:
// 8 for the learned cartpole model's n_state 5 and the slew rate's 6, both
// also compiled with n_state fixed; past n = 32 a 32-lane team that loops
// over its rows); lane i owns row i of F, C, V, V F and Q, and a step is
// three phases between warp barriers (riccati_team / riccati_looped in
// riccati_fused.cuh). Teams are independent and take no decision together,
// so the block size and where the team memory lives never change the bits
// (64, 128 or 256 threads a block; 128 by default). A block's teams are
// neighbours in B. Each lane loads its own rows of what later steps read
// -- its F row two phases before it is stored to the team's shared memory,
// its C row and c entry right after their use, the step's u and bounds a
// step ahead -- with plain loads into registers, so device memory latency
// stays off the chain. (A cp.async ring of the same rows, in 8-byte pieces
// where a row's 24 bytes allow no 16, spent about half of each step in
// address and issue instructions; PERF.md, Findings.) An example-invariant
// C (T and B strides 0, the learned-model path's cost) is read once into the
// block's shared memory. The box bounds are formed in the kernel from u,
// the bounds (numbers or strided tensors) and delta_u, and the u_zero_I
// mask is read as bytes, so a call is one launch. K and k are written by
// the lanes that own them: a warp's stores at a step are one contiguous run
// of its teams' consecutive examples.
//
// What bounds it. Per example and step about 80 floats move (C 36, c 6,
// F 30, u 1, K/k 6 at n_state 5) for about 400 FLOP: 1.25 FLOP a byte, far
// under the card's 20 FLOP a byte in float32, so bytes bound it: 7.6 us at
// B=4096, T=20, and 4.1 us with C expanded from one matrix. What sets the
// time is one team's serial chain of T steps, nearly the same at B=1024 and
// B=4096: each phase issues its shared-memory loads and its unrolled
// multiply-adds one warp instruction at a time. So the inner loops run to
// L (or to the compiled n_state) with no bound check (zero rows stand in
// for what lies past n_state), and rows are read four floats an
// instruction.
//
// Numerics: f32, no -use_fast_math; nvcc's FMA contraction moves results by
// a few ulp from the plain PyTorch version (riccati_fused_reference).
#include <cuda_runtime.h>

#include "riccati_fused.cuh"

namespace dilqr {

template <int L, int MODE, int NXC>
__global__ void __launch_bounds__(256, 1) riccati_fused_kernel(const RiccatiArgs a,
                                                               const RiccatiLayout y) {
  extern __shared__ __align__(16) float smem[];
  const int team = threadIdx.x / L;
  const int b0 = blockIdx.x * (blockDim.x / L) + team;
  const bool live = b0 < a.B;  // a team past the batch's end stores nothing
  if (a.sCt == 0 && a.sCb == 0) {
    ric_block_C<L>(a, smem, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  DeviceTeam<RicLane<L>, L> tm{(int)(threadIdx.x & (L - 1)), {}};
  riccati_team<L, MODE, NXC>(a, y, live ? b0 : a.B - 1, live, smem,
                        smem + y.block + (size_t)team * y.team, tm);
}

template <int MODE>
__global__ void __launch_bounds__(256, 1) riccati_looped_kernel(const RiccatiArgs a,
                                                                const RiccatiLayout y) {
  extern __shared__ __align__(16) float smem[];
  constexpr int L = kRicMaxLanes;
  const int team = threadIdx.x / L;
  const int g = blockIdx.x * (blockDim.x / L) + team;
  const bool live = g < a.B;
  float* ts = a.scratch ? a.scratch + (size_t)g * y.team : smem + (size_t)team * y.team;
  DeviceTeam<RicLane<L>, L> tm{(int)(threadIdx.x & (L - 1)), {}};
  riccati_looped<MODE>(a, y, live ? g : a.B - 1, live, ts, tm);
}

template <class K>
int launch_kernel(K kernel, const RiccatiArgs& a, const RiccatiLayout& y, int block, int teams,
                  int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {  // more than 48 KB a block needs the attribute, per device
    const int e = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            smem);
    if (e) return e;
  }
  const dim3 grid((a.B + teams - 1) / teams);
  kernel<<<grid, block, smem, st>>>(a, y);
  return (int)cudaGetLastError();
}

template <int L, int NXC>
int launch(int mode, const RiccatiArgs& a, int block, int teams, int smem, cudaStream_t st) {
  const RiccatiLayout y = riccati_layout(a.nx);
  if constexpr (L == 0) {
    if (mode == kModeFree) return launch_kernel(riccati_looped_kernel<kModeFree>, a, y, block, teams, smem, st);
    if (mode == kModeBox) return launch_kernel(riccati_looped_kernel<kModeBox>, a, y, block, teams, smem, st);
    if (mode == kModeZero) return launch_kernel(riccati_looped_kernel<kModeZero>, a, y, block, teams, smem, st);
  } else {
    if (mode == kModeFree) return launch_kernel(riccati_fused_kernel<L, kModeFree, NXC>, a, y, block, teams, smem, st);
    if (mode == kModeBox) return launch_kernel(riccati_fused_kernel<L, kModeBox, NXC>, a, y, block, teams, smem, st);
    if (mode == kModeZero) return launch_kernel(riccati_fused_kernel<L, kModeZero, NXC>, a, y, block, teams, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace dilqr

// out[6]: see dilqr::riccati_plan. block: threads a block (64, 128 or 256).
extern "C" int dilqr_riccati_plan(int nx, int block, int force_global, int* out) {
  return dilqr::riccati_plan(nx, block, force_global, out) ? (int)cudaErrorInvalidValue : 0;
}

// One call, its arguments packed (a ctypes call converts each argument on
// the host, and a call is host-bound at the learned model's sizes):
//   ia = {nx, mode, T, B, block, force_global, C, sCt, sCb, c, sct, scb,
//         F, sFt, sFb, u, sut, sub, lo, slt, slb, hi, sht, shb, uz, szt, szb,
//         K, k, scratch}   (pointers as integers; see RiccatiArgs)
//   fa = {lo_v, hi_v, du}
// lo/hi 0: the numbers lo_v/hi_v; du: delta_u, +inf for none; scratch:
// [teams of the grid, floats a team] when the plan puts the team memory in
// device memory (0 otherwise).
extern "C" int dilqr_riccati_fused(const long long* ia, const double* fa, void* stream) {
  const int nx = (int)ia[0], mode = (int)ia[1], T = (int)ia[2], B = (int)ia[3];
  int p[6];
  if (B <= 0 || T < 1 || dilqr::riccati_plan(nx, (int)ia[4], (int)ia[5], p))
    return (int)cudaErrorInvalidValue;
  float* scratch = reinterpret_cast<float*>(ia[29]);
  if (p[3] && !scratch) return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return reinterpret_cast<const float*>(ia[i]); };
  const dilqr::RiccatiArgs a{T, B, nx,
                             f(6), ia[7], ia[8], f(9), ia[10], ia[11], f(12), ia[13], ia[14],
                             f(15), ia[16], ia[17], f(18), ia[19], ia[20], (float)fa[0],
                             f(21), ia[22], ia[23], (float)fa[1], (float)fa[2],
                             reinterpret_cast<const unsigned char*>(ia[24]), ia[25], ia[26],
                             reinterpret_cast<float*>(ia[27]), reinterpret_cast<float*>(ia[28]),
                             p[3] ? scratch : nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dilqr::riccati_dispatch(nx, [&](auto s) {
    return dilqr::launch<decltype(s)::L, decltype(s)::NXC>(mode, a, (int)ia[4], p[1], p[2], st);
  });
}
