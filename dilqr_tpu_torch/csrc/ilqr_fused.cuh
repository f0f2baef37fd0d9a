// Per-example math of the whole-solve iLQR kernel (ilqr_fused.cu): the env
// steps and Jacobians in their kernel form, and the quadratic objective.
//
// These are the device counterparts of dilqr_tpu_torch/models/cartpole.py
// and pendulum.py (`kernel_step`, `jac_lanes`): the clamped step advances
// the angle with the angle-addition identities plus one rsqrt
// renormalization (rotate_cs, kernel form, with its zero-norm guard), and
// the Jacobian is the hand-derived one of the un-clamped step. The
// functions are __host__ __device__ so a host compiler can build them too.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define DILQR_HD __host__ __device__ __forceinline__
#else
#define DILQR_HD inline
#endif

namespace dilqr {

constexpr float kDt = 0.05f;

// ids shared with the Python side (models/*.py DEVICE_ENV)
enum EnvId { ENV_CARTPOLE = 0, ENV_PENDULUM = 1 };

DILQR_HD float rsqrt_f(float v) {
#ifdef __CUDA_ARCH__
  return rsqrtf(v);
#else
  return 1.0f / sqrtf(v);
#endif
}

// jnp.clip / torch.clamp semantics: NaN propagates
DILQR_HD float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// (cos, sin) of atan2(s, c) + delta without recovering the angle.
DILQR_HD void rotate_cs(float c, float s, float delta, float* oc, float* os) {
  const float cd = cosf(delta);
  const float sd = sinf(delta);
  const float ct = c * cd - s * sd;
  const float st = s * cd + c * sd;
  const float nn = ct * ct + st * st;
  const float r = rsqrt_f(fmaxf(nn, 1e-30f));
  // atan2(0, 0) = 0: the sequential form returns (cos delta, sin delta)
  const bool zero = nn == 0.0f;
  *oc = zero ? cd : ct * r;
  *os = zero ? sd : st * r;
}

// Cartpole: state (x, x_dot, cos th, sin th, th_dot), force clamped to
// +-100, params (gravity, masscart, masspole, length).
struct Cartpole {
  static constexpr int NX = 5;
  static constexpr int NP = 4;
  float g, mc, mp, l;

  DILQR_HD void load(const float* p) {
    g = p[0];
    mc = p[1];
    mp = p[2];
    l = p[3];
  }

  DILQR_HD void step(const float* xs, float u, float* xn) const {
    const float uu = u > 100.0f ? 100.0f : (u < -100.0f ? -100.0f : u);
    const float tm = mp + mc;
    const float pml = mp * l;
    const float x = xs[0], dx = xs[1], c = xs[2], s = xs[3], w = xs[4];
    const float cart_in = (uu + pml * (w * w) * s) / tm;
    const float th_acc = (g * s - c * cart_in) / (l * (4.0f / 3.0f - mp * (c * c) / tm));
    const float xacc = cart_in - pml * th_acc * c / tm;
    xn[0] = x + kDt * dx;
    xn[1] = dx + kDt * xacc;
    rotate_cs(c, s, kDt * w, &xn[2], &xn[3]);
    xn[4] = w + kDt * th_acc;
  }

  // D = [dx'/dx | dx'/du] of the un-clamped step, [5][6]
  DILQR_HD void jac(const float* xs, float u, float D[NX][NX + 1]) const {
    const float tm = mp + mc;
    const float pml = mp * l;
    const float dt = kDt;
    const float c = xs[2], s = xs[3], w = xs[4];
    const float ci = (u + pml * (w * w) * s) / tm;
    const float den = l * (4.0f / 3.0f - mp * (c * c) / tm);
    const float ta = (g * s - c * ci) / den;
    const float ci_s = pml * (w * w) / tm;
    const float ci_w = 2.0f * pml * w * s / tm;
    const float ci_u = 1.0f / tm;
    const float den_c = -2.0f * l * mp * c / tm;
    const float ta_c = (-ci - ta * den_c) / den;
    const float ta_s = (g - c * ci_s) / den;
    const float ta_w = -c * ci_w / den;
    const float ta_u = -c * ci_u / den;
    const float k = pml / tm;
    const float xacc_c = -k * (ta_c * c + ta);
    const float xacc_s = ci_s - k * ta_s * c;
    const float xacc_w = ci_w - k * ta_w * c;
    const float xacc_u = ci_u - k * ta_u * c;

    const float delta = dt * w;
    const float cd = cosf(delta);
    const float sd = sinf(delta);
    const float ct = c * cd - s * sd;
    const float st = s * cd + c * sd;
    const float nn = ct * ct + st * st;
    const float r = rsqrt_f(fmaxf(nn, 1e-30f));
    const float r2 = r * r;
    const float A_c = ct * cd + st * sd;
    const float A_s = -ct * sd + st * cd;
    const float o3 = ct * r;
    const float o4 = st * r;

    D[0][0] = 1.0f; D[0][1] = dt;   D[0][2] = 0.0f; D[0][3] = 0.0f; D[0][4] = 0.0f; D[0][5] = 0.0f;
    D[1][0] = 0.0f; D[1][1] = 1.0f;
    D[1][2] = dt * xacc_c; D[1][3] = dt * xacc_s; D[1][4] = dt * xacc_w; D[1][5] = dt * xacc_u;
    D[2][0] = 0.0f; D[2][1] = 0.0f;
    D[2][2] = r * (cd - ct * A_c * r2); D[2][3] = r * (-sd - ct * A_s * r2);
    D[2][4] = -dt * o4; D[2][5] = 0.0f;
    D[3][0] = 0.0f; D[3][1] = 0.0f;
    D[3][2] = r * (sd - st * A_c * r2); D[3][3] = r * (cd - st * A_s * r2);
    D[3][4] = dt * o3; D[3][5] = 0.0f;
    D[4][0] = 0.0f; D[4][1] = 0.0f;
    D[4][2] = dt * ta_c; D[4][3] = dt * ta_s; D[4][4] = 1.0f + dt * ta_w; D[4][5] = dt * ta_u;
  }
};

// Simple pendulum: state (cos th, sin th, th_dot), torque clamped to +-2,
// params (g, m, l).
struct Pendulum {
  static constexpr int NX = 3;
  static constexpr int NP = 3;
  float g, m, l;

  DILQR_HD void load(const float* p) {
    g = p[0];
    m = p[1];
    l = p[2];
  }

  DILQR_HD void step(const float* xs, float u, float* xn) const {
    const float uu = u > 2.0f ? 2.0f : (u < -2.0f ? -2.0f : u);
    const float c = xs[0], s = xs[1], w = xs[2];
    const float newdth = w + kDt * (-3.0f * g / (2.0f * l) * (-s) + 3.0f * uu / (m * (l * l)));
    rotate_cs(c, s, newdth * kDt, &xn[0], &xn[1]);
    xn[2] = newdth;
  }

  // D = [dx'/dx | dx'/du] of the un-clamped step, [3][4]
  DILQR_HD void jac(const float* xs, float u, float D[NX][NX + 1]) const {
    const float dt = kDt;
    const float c = xs[0], s = xs[1], w = xs[2];
    const float k_s = dt * 1.5f * g / l;
    const float k_u = dt * 3.0f / (m * (l * l));
    const float newdth = w + dt * (-3.0f * g / (2.0f * l) * (-s) + 3.0f * u / (m * (l * l)));
    const float delta = newdth * dt;
    const float d_s = dt * k_s, d_w = dt, d_u = dt * k_u;
    const float cd = cosf(delta);
    const float sd = sinf(delta);
    const float ct = c * cd - s * sd;
    const float st = s * cd + c * sd;
    const float nn = ct * ct + st * st;
    const float r = rsqrt_f(fmaxf(nn, 1e-30f));
    const float r2 = r * r;
    const float ct_c = cd, st_c = sd;
    const float ct_s = -sd - st * d_s, st_s = cd + ct * d_s;
    const float ct_w = -st * d_w, st_w = ct * d_w;
    const float ct_u = -st * d_u, st_u = ct * d_u;
    const float A_c = ct * ct_c + st * st_c;
    const float A_s = ct * ct_s + st * st_s;
    const float A_w = ct * ct_w + st * st_w;
    const float A_u = ct * ct_u + st * st_u;
    D[0][0] = r * (ct_c - ct * A_c * r2);
    D[0][1] = r * (ct_s - ct * A_s * r2);
    D[0][2] = r * (ct_w - ct * A_w * r2);
    D[0][3] = r * (ct_u - ct * A_u * r2);
    D[1][0] = r * (st_c - st * A_c * r2);
    D[1][1] = r * (st_s - st * A_s * r2);
    D[1][2] = r * (st_w - st * A_w * r2);
    D[1][3] = r * (st_u - st * A_u * r2);
    D[2][0] = 0.0f;
    D[2][1] = k_s;
    D[2][2] = 1.0f;
    D[2][3] = k_u;
  }
};

// 0.5 tau^T C tau + c^T tau for tau = (x, u); C row-major [N*N], c [N]
template <int N>
DILQR_HD float objective(const float* tau, const float* C, const float* c) {
  float quad = 0.0f, lin = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float ct = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) ct += C[i * N + j] * tau[j];
    quad += tau[i] * ct;
    lin += c[i] * tau[i];
  }
  return 0.5f * quad + lin;
}

}  // namespace dilqr
