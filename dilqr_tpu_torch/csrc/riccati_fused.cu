// Reverse Riccati kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_riccati_kernel`
// (dilqr_tpu/ops/pallas/riccati_fused.py:57, called through
// `lqr_backward_pallas` :161): the T-step reverse Riccati recursion of one
// control, closed-form QP, in the free, box and zero (u_zero_I) gain modes.
// It is the Riccati backward of every iteration of the plain iLQR loop for
// the solves the whole-solve kernel refuses (the MLP dynamics model, the
// slew-rate augmentation, the affine model, u_zero_I, delta_u), and the
// auxiliary LQR of the KKT backward where the KKT kernel has no
// instantiation.
//
// Design. One thread per example runs the whole recursion with V, v and
// one step's F, Q and V F column in registers (riccati_example in
// riccati_fused.cuh). Unlike the whole-solve kernel, it takes no decision
// per tile -- no any, no max, no vote -- so the block size is free and the
// result does not depend on it: 64 threads a block by default, which
// spreads B=4096 over 64 SMs. The inputs are read where they lie, time-major
// [T, B, ...], through their T and B strides (an expanded C costs no copy);
// K [T, B, NX] and k [T, B] are written in place. The TPU kernel's
// batch-on-lanes transposes would cost a PyTorch launch each on a path that
// is host-bound already.
//
// What bounds it. Per example and step about 80 floats move (C 36, c 6,
// F 30, bounds 2, K/k 6 at NX=5) for about 400 FLOP: 1.25 FLOP a byte,
// far under the card's 20 FLOP a byte in float32. It is bound by bytes;
// each input is read once and the recursion's state stays on chip. Within
// a step each thread reads a contiguous run of C and F, so a warp touches
// whole lines that L1 serves to the next loads.
//
// Numerics: f32, no -use_fast_math; nvcc's FMA contraction moves results by
// a few ulp from the plain PyTorch version (riccati_fused_reference).
#include <cuda_runtime.h>

#include "riccati_fused.cuh"

namespace dilqr {

constexpr int kRiccatiBlock = 64;

template <int NX, int MODE>
__global__ void riccati_fused_kernel(const RiccatiArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  riccati_example<NX, MODE>(a, b);
}

template <int NX>
int launch(int mode, const RiccatiArgs& a, int block, cudaStream_t st) {
  const dim3 grid((a.B + block - 1) / block);
  if (mode == kModeFree) riccati_fused_kernel<NX, kModeFree><<<grid, block, 0, st>>>(a);
  else if (mode == kModeBox) riccati_fused_kernel<NX, kModeBox><<<grid, block, 0, st>>>(a);
  else if (mode == kModeZero) riccati_fused_kernel<NX, kModeZero><<<grid, block, 0, st>>>(a);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace dilqr

// block: threads a block, 0 for kRiccatiBlock
extern "C" int dilqr_riccati_fused(int nx, int mode, int T, int B, int block,
                                   const float* C, long long sCt, long long sCb,
                                   const float* c, long long sct, long long scb,
                                   const float* F, long long sFt, long long sFb,
                                   const float* lb, const float* ub, float* K, float* k,
                                   void* stream) {
  if (B <= 0 || T < 1 || block < 0 || block > 1024) return (int)cudaErrorInvalidValue;
  const dilqr::RiccatiArgs a{T, B, C, sCt, sCb, c, sct, scb, F, sFt, sFb, lb, ub, K, k};
  const int bs = block ? block : dilqr::kRiccatiBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DILQR_RICCATI_CASE(X_) \
  if (nx == X_) return dilqr::launch<X_>(mode, a, bs, st);
  DILQR_RICCATI_NX(DILQR_RICCATI_CASE)
#undef DILQR_RICCATI_CASE
  return (int)cudaErrorInvalidValue;
}
