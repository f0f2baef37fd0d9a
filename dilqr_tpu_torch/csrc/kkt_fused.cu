// Module-KKT VJP kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_kkt_kernel`
// (dilqr_tpu/ops/pallas/kkt_fused.py:173) and `_kkt_stream_kernel`
// (kkt_fused.py:306), both called through `make_kkt_vjp_pallas`: the
// backward of every GMRES iteration of the IFT gradient and the one
// KKT-mode VJP. Per example: the reverse Riccati of the auxiliary LQR
// (C, -r, F) with the frozen active set's zero-mask gains, its alpha=1
// rollout (dtau), and the joint reverse recursion of lam and dlam. The
// rank-1 assembly of dF and dC stays outside, in the wrapper, as in JAX.
//
// Design. One thread per example; the per-example math is kkt_example in
// kkt_fused.cuh. Examples are independent -- unlike the whole-solve
// kernel, no decision is taken per tile -- so the block size is free:
// 32 threads a block (one warp), which spreads B=4096 over 128 blocks,
// that is over 128 of the 132 SMs, where 1024-thread blocks would use 4.
// Every per-step array is laid out [T, k, B] in global memory, inputs,
// outputs and the K/k scratch alike, so a warp's loads and stores are
// 128-byte lines and any horizon runs: the guarantee of the JAX stream
// variant (any T) without its DMA staging, which is a TPU mechanism.
// V, v and one step's Q and F live in registers or, where they do not fit
// (rocket, NX=13, NU=3: V is 13x13, Q 16x16), in local memory; ptxas's
// spill report for each instantiation is printed by chip_smoke.py.
//
// What bounds it. Per example and step the kernel moves about 91 floats
// at cartpole (C triangle 21, F 30, r 6, uz 1, offset 5 in; dtau 6, lam 5,
// dlam 5 out; K/k written and read back, 12) for about 1,150 FLOP: about
// 3 FLOP a byte, far under the card's 20 FLOP a byte in float32 outside
// the tensor cores. It is bound by bytes; the design reads and writes each
// array once a pass, coalesced, and keeps the recursions' state on chip.
//
// Numerics: f32, no -use_fast_math; nvcc's FMA contraction moves results
// by a few ulp from the plain PyTorch version (kkt_fused_reference).
#include <cuda_runtime.h>

#include "kkt_fused.cuh"

namespace dilqr {

constexpr int kKktBlock = 32;

template <int NX, int NU>
__global__ void __launch_bounds__(kKktBlock) kkt_fused_kernel(const KktArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  kkt_example<NX, NU>(a, b);
}

}  // namespace dilqr

extern "C" int dilqr_kkt_fused(int nx, int nu, int T, int B, const float* C,
                               const float* F, const float* r, const float* uz,
                               const float* lb, float* dtau, float* lam, float* dlam,
                               float* K, float* k, void* stream) {
  if (B <= 0 || T < 2) return (int)cudaErrorInvalidValue;
  const dilqr::KktArgs a{T, B, C, F, r, uz, lb, dtau, lam, dlam, K, k};
  const dim3 grid((B + dilqr::kKktBlock - 1) / dilqr::kKktBlock), block(dilqr::kKktBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DILQR_KKT_CASE(X_, U_)                                             \
  if (nx == X_ && nu == U_) {                                              \
    dilqr::kkt_fused_kernel<X_, U_><<<grid, block, 0, st>>>(a);            \
    return (int)cudaGetLastError();                                        \
  }
  DILQR_KKT_SHAPES(DILQR_KKT_CASE)
#undef DILQR_KKT_CASE
  return (int)cudaErrorInvalidValue;
}
