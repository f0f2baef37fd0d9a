// The cost form a library of the whole-solve kernel is built for: with
// -DDILQR_CALLABLE_COST=1, a callable cost that ops/cuda/traced.py traced
// from the user's PyTorch code and generated as C++ (traced::Cost in the
// header dilqr_traced.cuh, which ops/cuda/build.py writes beside the
// library and puts on the include path); else the QuadCost forms. A
// callable-cost library has the example-invariant form's instantiations
// only (the cost has no C or c to lay out), and no slew-rate wrapper: the
// slew rate's augmented cost captures its matrix, which the trace refuses.
#pragma once

#include "ilqr_kernel.cuh"

#if defined(DILQR_CALLABLE_COST) && DILQR_CALLABLE_COST
#include "dilqr_traced.cuh"
namespace dilqr {
using KernelCost = traced::Cost;
constexpr bool kCallableCost = true;
}  // namespace dilqr
#else
namespace dilqr {
using KernelCost = QuadForm;
constexpr bool kCallableCost = false;
}  // namespace dilqr
#endif
