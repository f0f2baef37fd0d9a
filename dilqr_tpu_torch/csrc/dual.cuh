// Forward-mode scalars for the whole-solve kernel's jvp sweep: a Dual holds
// a value and one tangent, and the functions below carry both through the
// env steps (ilqr_fused.cuh, JvpJac), so that one step evaluated with a
// one-hot tangent gives one column of its Jacobian -- the counterpart of
// the jax.linearize / jvp columns of `lin_at` in the JAX kernel
// (dilqr_tpu/ops/pallas/ilqr_fused.py:1258-1266). One tangent per
// evaluation, as lin_at takes them: a Dual doubles the live values of a
// step, where a vector of n tangents would multiply them by n + 1.
//
// The steps are templates over their scalar type S (float or Dual) and
// call the overloads here by name: for a float each is the function the
// steps called before they were templates (rsqrt_f, fmaxf, cos_sin, ...),
// so the float instantiations compile as they did.
//
// The tangent rules are PyTorch's forward-mode ones, so the plain version
// (torch.func.jvp of the kernel-form step) takes the same derivative:
//  * clamp_sel(u, lo, hi) = u > hi ? hi : (u < lo ? lo : u) on whole duals:
//    tangent 1 on the closed interval and 0 strictly outside it, the
//    derivative of torch.clamp and of clamp_t (dilqr_tpu/utils/batch.py:
//    61-70). A control the line search parks exactly on a bound keeps its
//    column; fminf/fmaxf on duals would pick a side or average at the tie.
//  * fmax_s(a, b) with a constant b: torch.clamp(a, min=b), the tangent
//    passes where a >= b;
//  * sqrt, rsqrt, atan2, cos and sin: the value by the float function the
//    step uses (rsqrt_f is rsqrtf on the card), the tangent by the
//    derivative at that value.
//
// Every Dual form computes its value by the same function of the value
// part, so the forms recurse: DualOf<DualOf<float>> carries a second
// tangent, the forward-over-forward a callable cost's Hessian needs
// (ilqr_fused.cuh, quad_at). A constant beside a Dual has the real type
// underneath it, real_t (float on the card, double in a host build), so
// a host build at double keeps every digit of a constant. The code that
// ops/cuda/traced.py generates from a user's PyTorch step or cost calls
// the functions below by name and compares values with rv().
#pragma once

#include <math.h>

#ifndef DILQR_HD
#ifdef __CUDACC__
#define DILQR_HD __host__ __device__ __forceinline__
#else
#define DILQR_HD inline
#endif
#endif

namespace dilqr {

DILQR_HD float rsqrt_f(float v) {
#ifdef __CUDA_ARCH__
  return rsqrtf(v);
#else
  return 1.0f / sqrtf(v);
#endif
}

// (cos x, sin x) of a float, evaluated in double and rounded once: x is
// reduced by pi/2 in two parts with fused multiply-adds (the product with
// the leading part exact), then the Taylor polynomials to degree 14 and 13
// on |r| <= pi/4 (truncation below 1e-13). Within an ulp of cosf/sinf, and
// unlike them it has no Payne-Hanek fallback for huge arguments, whose
// word table and call put a stack frame (and, around the call, spills)
// into every kernel that inlines it. Accurate for |x| < 1e15, where the
// reduction's second part still holds; NaN for a NaN or infinite x. D is
// double; a host build may put a type there that counts the operations.
template <class D = double>
DILQR_HD void cos_sin(float xf, float* oc, float* os) {
  const D x = xf;
  const D j = rint(x * 0.63661977236758134);  // 2 / pi
  const D r = fma(-j, 6.123233995736766e-17, fma(-j, 1.5707963267948966, x));
  const D r2 = r * r;
  const D sr = r * (1.0 + r2 * (-1.0 / 6 + r2 * (1.0 / 120 + r2 * (-1.0 / 5040
               + r2 * (1.0 / 362880 + r2 * (-1.0 / 39916800 + r2 * (1.0 / 6227020800.0)))))));
  const D cr = 1.0 + r2 * (-0.5 + r2 * (1.0 / 24 + r2 * (-1.0 / 720 + r2 * (1.0 / 40320
               + r2 * (-1.0 / 3628800 + r2 * (1.0 / 479001600.0 + r2 * (-1.0 / 87178291200.0)))))));
  const D m = j - 4.0 * floor(0.25 * j);  // the quadrant, 0..3 (NaN for NaN)
  const D c = m == 0.0 ? cr : (m == 1.0 ? -sr : (m == 2.0 ? -cr : (m == 3.0 ? sr : r)));
  const D s = m == 0.0 ? sr : (m == 1.0 ? cr : (m == 2.0 ? -sr : (m == 3.0 ? -cr : r)));
  *oc = (float)c;
  *os = (float)s;
}

// R is float; a host build may put a type there that counts the operations
template <class R>
struct DualOf {
  R v;  // value
  R d;  // tangent
  DualOf() = default;
  DILQR_HD constexpr DualOf(R value, R tangent = R(0.0f)) : v(value), d(tangent) {}
};
using Dual = DualOf<float>;

// the real type under a scalar: float for float and Dual, double for
// double and DualOf<double>
template <class S>
struct RealOf {
  using type = S;
};
template <class R>
struct RealOf<DualOf<R>> {
  using type = typename RealOf<R>::type;
};
template <class S>
using real_t = typename RealOf<S>::type;

// the innermost value of a scalar (what a comparison reads)
template <class S>
DILQR_HD real_t<S> rv(S a) { return a; }
template <class R>
DILQR_HD real_t<R> rv(DualOf<R> a) { return rv(a.v); }

// a parameter read: through the read-only cache on the card (every thread
// of a warp reads the same one), a double as it is in a host build
DILQR_HD float ld_param(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}
DILQR_HD double ld_param(const double* p) { return *p; }

template <class R>
DILQR_HD DualOf<R> operator-(DualOf<R> a) { return {-a.v, -a.d}; }
template <class R>
DILQR_HD DualOf<R> operator+(DualOf<R> a, DualOf<R> b) { return {a.v + b.v, a.d + b.d}; }
template <class R>
DILQR_HD DualOf<R> operator+(DualOf<R> a, real_t<R> b) { return {a.v + b, a.d}; }
template <class R>
DILQR_HD DualOf<R> operator+(real_t<R> a, DualOf<R> b) { return {a + b.v, b.d}; }
template <class R>
DILQR_HD DualOf<R> operator-(DualOf<R> a, DualOf<R> b) { return {a.v - b.v, a.d - b.d}; }
template <class R>
DILQR_HD DualOf<R> operator-(DualOf<R> a, real_t<R> b) { return {a.v - b, a.d}; }
template <class R>
DILQR_HD DualOf<R> operator-(real_t<R> a, DualOf<R> b) { return {a - b.v, -b.d}; }
template <class R>
DILQR_HD DualOf<R> operator*(DualOf<R> a, DualOf<R> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <class R>
DILQR_HD DualOf<R> operator*(DualOf<R> a, real_t<R> b) { return {a.v * b, a.d * b}; }
template <class R>
DILQR_HD DualOf<R> operator*(real_t<R> a, DualOf<R> b) { return {a * b.v, a * b.d}; }
template <class R>
DILQR_HD DualOf<R> operator/(DualOf<R> a, DualOf<R> b) {
  const R q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <class R>
DILQR_HD DualOf<R> operator/(DualOf<R> a, real_t<R> b) { return {a.v / b, a.d / b}; }
template <class R>
DILQR_HD DualOf<R> operator/(real_t<R> a, DualOf<R> b) {
  const R q = a / b.v;
  return {q, -q * b.d / b.v};
}

// comparisons read the values (a NaN compares false, as for floats)
template <class R>
DILQR_HD bool operator<(DualOf<R> a, real_t<R> b) { return a.v < b; }
template <class R>
DILQR_HD bool operator>(DualOf<R> a, real_t<R> b) { return a.v > b; }
template <class R>
DILQR_HD bool operator==(DualOf<R> a, real_t<R> b) { return a.v == b; }

// u > hi ? hi : (u < lo ? lo : u): the in-step control clamp, with
// torch.clamp's derivative on a Dual (tangent 1 on [lo, hi], bounds
// included; 0 outside; NaN passes through)
template <class S>
DILQR_HD S clamp_sel(S u, real_t<S> lo, real_t<S> hi) {
  return u > hi ? S(hi) : (u < lo ? S(lo) : u);
}

// The real forms first (float on the card, double in a host build), then
// the Dual forms, each computing its value by the real form of the value
// part, so that they recurse
DILQR_HD float sqrt_s(float a) { return sqrtf(a); }
DILQR_HD double sqrt_s(double a) { return sqrt(a); }
DILQR_HD float rsqrt_s(float a) { return rsqrt_f(a); }
DILQR_HD double rsqrt_s(double a) { return 1.0 / sqrt(a); }
DILQR_HD float atan2_s(float y, float x) { return atan2f(y, x); }
DILQR_HD double atan2_s(double y, double x) { return atan2(y, x); }
// (cos a, sin a): by cos_sin for a float, by the library for a double
DILQR_HD void cos_sin_s(float a, float* oc, float* os) { cos_sin(a, oc, os); }
DILQR_HD void cos_sin_s(double a, double* oc, double* os) {
  *oc = cos(a);
  *os = sin(a);
}

template <class R>
DILQR_HD DualOf<R> sqrt_s(DualOf<R> a) {
  const R r = sqrt_s(a.v);
  return {r, a.d / (2.0f * r)};
}

template <class R>
DILQR_HD DualOf<R> rsqrt_s(DualOf<R> a) {
  const R r = rsqrt_s(a.v);
  return {r, -0.5f * (r * r * r) * a.d};
}

// fmaxf(a, b) for a constant b: torch.clamp(a, min=b) on a Dual
DILQR_HD float fmax_s(float a, float b) { return fmaxf(a, b); }
template <class R>
DILQR_HD DualOf<R> fmax_s(DualOf<R> a, real_t<R> b) {
  return {fmaxf(a.v, b), a.v >= b ? a.d : R(0.0f)};
}

template <class R>
DILQR_HD DualOf<R> atan2_s(DualOf<R> y, DualOf<R> x) {
  return {atan2_s(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}

template <class R>
DILQR_HD void cos_sin_s(DualOf<R> a, DualOf<R>* oc, DualOf<R>* os) {
  R c, s;
  cos_sin_s(a.v, &c, &s);
  *oc = DualOf<R>(c, -s * a.d);
  *os = DualOf<R>(s, c * a.d);
}

// The MLP's activations (Mlp in ilqr_fused.cuh), with the derivative
// conventions of JAX's jax.nn functions, which PyTorch's forward mode
// shares (the plain version jvps torch.sigmoid, torch.relu and elu):
//  * sigmoid(a) = 1 / (1 + exp(-a)), tangent s (1 - s) d;
//  * relu(a) = a < 0 ? 0 : a (NaN passes), tangent d where a > 0, else 0
//    (relu'(0) = 0);
//  * elu(a) = a > 0 ? a : expm1(a), tangent d where a > 0, else
//    (expm1(a) + 1) d (elu'(0) = 1, the a > 0 false branch).
// The value forms are templates over a scalar that is not a Dual (float,
// double in a host build, or a host type that counts the operations); a
// Dual's tangent adds one product (sigmoid, elu) or none (relu). Both
// branches of elu are computed and one is selected, as the card does.
DILQR_HD float exp_s(float a) { return expf(a); }
DILQR_HD double exp_s(double a) { return exp(a); }
DILQR_HD float expm1_s(float a) { return expm1f(a); }
DILQR_HD double expm1_s(double a) { return expm1(a); }

template <class S>
DILQR_HD S sigmoid_s(S a) {
  return 1.0f / (1.0f + exp_s(-a));
}
template <class R>
DILQR_HD DualOf<R> sigmoid_s(DualOf<R> a) {
  const R s = sigmoid_s(a.v);
  return {s, a.d * (s * (1.0f - s))};
}

template <class S>
DILQR_HD S relu_s(S a) {
  return a < 0.0f ? S(0.0f) : a;
}
template <class R>
DILQR_HD DualOf<R> relu_s(DualOf<R> a) {
  return {relu_s(a.v), a.v > 0.0f ? a.d : R(0.0f)};
}

template <class S>
DILQR_HD S elu_s(S a) {
  const S e = expm1_s(a);
  return a > 0.0f ? a : e;
}
template <class R>
DILQR_HD DualOf<R> elu_s(DualOf<R> a) {
  const R e = expm1_s(a.v);
  const R de = a.d * (e + 1.0f);
  const bool pos = a.v > 0.0f;
  return {pos ? a.v : e, pos ? a.d : de};
}

// The rest of the elementwise set a traced step or cost may use
// (ops/cuda/traced.py), with PyTorch's forward-mode derivatives:
//  * log, tanh: tangent d / a and (1 - t^2) d;
//  * abs: tangent d sgn(a) (0 at a == 0), by selection;
//  * pow_s(a, e) for a constant exponent: tangent e a^(e-1) d;
//  * max_s / min_s: torch.maximum / minimum, NaN propagating, the tangent
//    of the larger (smaller) one and the mean of both at a tie, both sides
//    computed so that the operation count does not depend on the data;
//  * clamp_lo / clamp_hi: torch.clamp with one bound, tangent 1 at the
//    bound, as clamp_sel.
DILQR_HD float log_s(float a) { return logf(a); }
DILQR_HD double log_s(double a) { return log(a); }
DILQR_HD float tanh_s(float a) { return tanhf(a); }
DILQR_HD double tanh_s(double a) { return tanh(a); }
DILQR_HD float abs_s(float a) { return fabsf(a); }
DILQR_HD double abs_s(double a) { return fabs(a); }
DILQR_HD float pow_s(float a, double e) { return powf(a, (float)e); }
DILQR_HD double pow_s(double a, double e) { return pow(a, e); }
DILQR_HD float max_s(float a, float b) { return a != a ? a : (b != b ? b : (a > b ? a : b)); }
DILQR_HD double max_s(double a, double b) { return a != a ? a : (b != b ? b : (a > b ? a : b)); }
DILQR_HD float min_s(float a, float b) { return a != a ? a : (b != b ? b : (a < b ? a : b)); }
DILQR_HD double min_s(double a, double b) { return a != a ? a : (b != b ? b : (a < b ? a : b)); }

template <class R>
DILQR_HD DualOf<R> exp_s(DualOf<R> a) {
  const R e = exp_s(a.v);
  return {e, a.d * e};
}
template <class R>
DILQR_HD DualOf<R> log_s(DualOf<R> a) {
  return {log_s(a.v), a.d / a.v};
}
template <class R>
DILQR_HD DualOf<R> tanh_s(DualOf<R> a) {
  const R t = tanh_s(a.v);
  return {t, a.d * (1.0f - t * t)};
}
template <class R>
DILQR_HD DualOf<R> abs_s(DualOf<R> a) {
  return {abs_s(a.v), rv(a.v) > 0.0f ? a.d : (rv(a.v) < 0.0f ? -a.d : R(0.0f))};
}
template <class R>
DILQR_HD DualOf<R> pow_s(DualOf<R> a, double e) {
  return {pow_s(a.v, e), a.d * (real_t<R>(e) * pow_s(a.v, e - 1.0))};
}
template <class R>
DILQR_HD DualOf<R> max_s(DualOf<R> a, DualOf<R> b) {
  const R tie = (a.d + b.d) * 0.5f;
  return {max_s(a.v, b.v), rv(a.v) == rv(b.v) ? tie : (rv(a.v) > rv(b.v) ? a.d : b.d)};
}
template <class R>
DILQR_HD DualOf<R> min_s(DualOf<R> a, DualOf<R> b) {
  const R tie = (a.d + b.d) * 0.5f;
  return {min_s(a.v, b.v), rv(a.v) == rv(b.v) ? tie : (rv(a.v) < rv(b.v) ? a.d : b.d)};
}
template <class S>
DILQR_HD S clamp_lo(S u, real_t<S> lo) {
  return u < lo ? S(lo) : u;
}
template <class S>
DILQR_HD S clamp_hi(S u, real_t<S> hi) {
  return u > hi ? S(hi) : u;
}

}  // namespace dilqr
