// Per-example math of the whole-solve iLQR kernel (ilqr_kernel.cuh): the env
// steps and Jacobians in their kernel form, the dynamics of a time-varying
// affine (LQR) problem as data (LinDx), the Jacobian by forward mode
// (JvpJac), the quadratic objective, the tile vote, the small-matrix pieces
// of the multi-control box-QP (explicit inverses, the projected-Newton step
// and its tile-voting loop) and the Riccati step over strided storage.
//
// The envs are the device counterparts of dilqr_tpu_torch/models/
// cartpole.py, pendulum.py and rocket.py (`kernel_step`, `jac_lanes`): the
// cartpole and pendulum steps advance the angle with the angle-addition
// identities plus one rsqrt renormalization (rotate_cs, kernel form, with
// its zero-norm guard); the rocket step is a polynomial map. Each step is a
// template over its scalar type (float, or a Dual of dual.cuh for the jvp
// sweep) and over the control clamp (the clamped step, or the un-clamped
// physics an ANALYTIC linearization differentiates). Cartpole, Pendulum and
// Rocket carry the hand-derived Jacobian of the un-clamped step, and so
// does Mlp, the learned model (models/nn_dynamics.py) with its widths as
// template parameters, for one hidden layer; PendulumComplex and RocketNorm
// have none and take JvpJac's, and so do a deeper Mlp and Traced, a user's
// model whose step
// ops/cuda/traced.py generated from its PyTorch code. The functions are
// __host__ __device__ so a host compiler can build them too.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#define DILQR_HD __host__ __device__ __forceinline__
#else
#define DILQR_HD inline
#endif

#include "dual.cuh"

namespace dilqr {

constexpr float kDt = 0.05f;

// ids shared with the Python side (models/*.py DEVICE_ENV; the
// slew-rate wrappers Passthrough<Env> in models/ctrl_passthrough.py)
enum EnvId {
  ENV_CARTPOLE = 0,
  ENV_PENDULUM = 1,
  ENV_ROCKET = 2,
  ENV_CARTPOLE_SLEW = 3,
  ENV_PENDULUM_SLEW = 4,
  ENV_ROCKET_SLEW = 5,
  ENV_PENDULUM_COMPLEX = 6,
  ENV_ROCKET_NORM = 7,
  ENV_PENDULUM_COMPLEX_SLEW = 8,
  ENV_ROCKET_NORM_SLEW = 9,
  ENV_MLP = 10,  // any Mlp<...> (ilqr_mlp.cu, one library per shape)
  ENV_MLP_SLEW = 11,
  ENV_TRACED = 12,  // a user's model traced into C++ (ilqr_user.cu, one library per model)
};

// the most controls the kernel takes (JAX's MAX_NU): a LinDx problem's;
// the envs with device code have at most 3 (the rocket's)
constexpr int kMaxNu = 8;

// jnp.clip / torch.clamp semantics: NaN propagates
DILQR_HD float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// jnp.maximum / jnp.minimum: a NaN in either argument propagates
DILQR_HD float maximum(float a, float b) {
  return a != a ? a : (a > b ? a : b);
}
DILQR_HD float minimum(float a, float b) {
  return a != a ? a : (a < b ? a : b);
}

// jnp.clip as min(max(v, lo), hi): hi when lo > hi (the delta_u clamp
// around an iterate that lies outside the box)
DILQR_HD float clip_ordered(float v, float lo, float hi) {
  return minimum(maximum(v, lo), hi);
}

// a read through the read-only cache on the device (the cost: every thread
// of a warp reads the same address)
DILQR_HD float ldg_f(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// the most warps a block of the whole-solve kernel has (128 threads)
constexpr int kMaxWarps = 4;

// The tile-wide vote. On the device a tile is one thread-block cluster of
// G blocks: each warp votes with __any_sync, lane 0 writes the warp's word
// into its block's shared memory, one cluster barrier publishes every
// word, and each lane ORs its share of the cluster's words through
// distributed shared memory before a last warp vote. The words are
// double-buffered by the vote count `n`: vote n+2 rewrites vote n's words
// only after every thread has passed vote n+1's barrier, so one barrier a
// vote is enough. Every thread of the cluster must reach every vote, in
// the same order (the branches around a vote are cluster-uniform). Built
// for the host, a tile is one example and the vote is the identity.
// all(p) is !any(!p): a NaN comparison is false in both forms. `cycles`
// sums the SM clock cycles spent in votes, the barrier's wait included.
struct TileVote {
  unsigned* words;  // [2 * kMaxWarps] in the block's shared memory; null on the host
  int n;            // votes taken
  long long cycles;

  DILQR_HD int any(int p) {
#ifdef __CUDA_ARCH__
    namespace cg = cooperative_groups;
    const long long t0 = clock64();
    cg::cluster_group cluster = cg::this_cluster();
    const int lane = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    unsigned* w = words + (n & 1) * kMaxWarps;
    ++n;
    const unsigned mine = __any_sync(0xffffffffu, p);
    if (lane == 0) w[threadIdx.x >> 5] = mine;
    cluster.sync();
    unsigned got = 0u;
    const int total = nw * (int)cluster.num_blocks();
    for (int l = lane; l < total; l += 32) got |= *cluster.map_shared_rank(w + l % nw, l / nw);
    const int result = __any_sync(0xffffffffu, got != 0u);
    cycles += clock64() - t0;
    return result;
#else
    ++n;
    return p;
#endif
  }

  DILQR_HD int all(int p) { return !any(!p); }
};

// Entries of one example's matrices with a stride between consecutive
// entries: on the device [entry][example] in shared memory (the stride is
// the block's examples, so a warp's 32 examples hit 32 banks); on the host
// any buffer.
struct Strided {
  float* p;
  int stride;
  DILQR_HD float& operator[](int e) const { return p[e * stride]; }
};

// a symmetric M x M matrix kept as its upper triangle, row-major
template <int M>
struct SymMat {
  static constexpr int kSize = M * (M + 1) / 2;
  Strided s;
  static constexpr DILQR_HD int idx(int i, int j) {
    return i <= j ? i * M - i * (i - 1) / 2 + (j - i) : j * M - j * (j - 1) / 2 + (i - j);
  }
  DILQR_HD float& operator()(int i, int j) const { return s[idx(i, j)]; }
};

// a dense R x C matrix, row-major, indexed D[i][j] as a 2-D array is
template <int R, int C>
struct DenseMat {
  static constexpr int kSize = R * C;
  Strided s;
  struct Row {
    float* p;
    int stride;
    DILQR_HD float& operator[](int j) const { return p[j * stride]; }
  };
  DILQR_HD Row operator[](int i) const { return {s.p + i * C * s.stride, s.stride}; }
};

// (cos, sin) of atan2(s, c) + delta without recovering the angle.
template <class S>
DILQR_HD void rotate_cs(S c, S s, S delta, S* oc, S* os) {
  S cd, sd;
  cos_sin_s(delta, &cd, &sd);
  const S ct = c * cd - s * sd;
  const S st = s * cd + c * sd;
  const S nn = ct * ct + st * st;
  const S r = rsqrt_s(fmax_s(nn, 1e-30f));
  // atan2(0, 0) = 0: the sequential form returns (cos delta, sin delta)
  const bool zero = nn == 0.0f;
  *oc = zero ? cd : ct * r;
  *os = zero ? sd : st * r;
}

// the in-step control clamp of the clamped step (kClamp), none in the
// un-clamped physics
template <bool kClamp, class S>
DILQR_HD S clamp_if(S u, float lo, float hi) {
  if constexpr (kClamp) {
    return clamp_sel(u, lo, hi);
  } else {
    return u;
  }
}

// Cartpole: state (x, x_dot, cos th, sin th, th_dot), force clamped to
// +-100, params (gravity, masscart, masspole, length).
struct Cartpole {
  static constexpr int NX = 5;
  static constexpr int NU = 1;
  static constexpr int NP = 4;
  static constexpr bool kColumnwiseQ = false;  // see the n_ctrl == 1 step in ilqr_fused.cu
  float g, mc, mp, l;

  DILQR_HD void load(const float* p) {
    g = p[0];
    mc = p[1];
    mp = p[2];
    l = p[3];
  }

  // x' = step(x, u): S is float or Dual; kClamp: the force clamped to
  // +-100 (the step), or not (the un-clamped physics)
  template <bool kClamp = true, class S>
  DILQR_HD void step(const S* xs, const S* us, S* xn) const {
    const S uu = clamp_if<kClamp>(us[0], -100.0f, 100.0f);
    const float tm = mp + mc;
    const float pml = mp * l;
    const S x = xs[0], dx = xs[1], c = xs[2], s = xs[3], w = xs[4];
    const S cart_in = (uu + pml * (w * w) * s) / tm;
    const S th_acc = (g * s - c * cart_in) / (l * (4.0f / 3.0f - mp * (c * c) / tm));
    const S xacc = cart_in - pml * th_acc * c / tm;
    xn[0] = x + kDt * dx;
    xn[1] = dx + kDt * xacc;
    rotate_cs(c, s, kDt * w, &xn[2], &xn[3]);
    xn[4] = w + kDt * th_acc;
  }

  // D = [dx'/dx | dx'/du] of the un-clamped step, [5][6]: a float[5][6] or
  // any view indexed D[i][j] (every entry is written)
  template <class Out>
  DILQR_HD void jac(const float* xs, const float* us, Out&& D) const {
    const float u = us[0];
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
    float cd, sd;
    cos_sin(delta, &cd, &sd);
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
  static constexpr int NU = 1;
  static constexpr int NP = 3;
  static constexpr bool kColumnwiseQ = false;
  float g, m, l;

  DILQR_HD void load(const float* p) {
    g = p[0];
    m = p[1];
    l = p[2];
  }

  // x' = step(x, u): S is float or Dual; kClamp: the torque clamped to
  // +-2, or not
  template <bool kClamp = true, class S>
  DILQR_HD void step(const S* xs, const S* us, S* xn) const {
    const S uu = clamp_if<kClamp>(us[0], -2.0f, 2.0f);
    const S c = xs[0], s = xs[1], w = xs[2];
    const S newdth = w + kDt * (-3.0f * g / (2.0f * l) * (-s) + 3.0f * uu / (m * (l * l)));
    rotate_cs(c, s, newdth * kDt, &xn[0], &xn[1]);
    xn[2] = newdth;
  }

  // D = [dx'/dx | dx'/du] of the un-clamped step, [3][4]: a float[3][4] or
  // any view indexed D[i][j] (every entry is written)
  template <class Out>
  DILQR_HD void jac(const float* xs, const float* us, Out&& D) const {
    const float u = us[0];
    const float dt = kDt;
    const float c = xs[0], s = xs[1], w = xs[2];
    const float k_s = dt * 1.5f * g / l;
    const float k_u = dt * 3.0f / (m * (l * l));
    const float newdth = w + dt * (-3.0f * g / (2.0f * l) * (-s) + 3.0f * u / (m * (l * l)));
    const float delta = newdth * dt;
    const float d_s = dt * k_s, d_w = dt, d_u = dt * k_u;
    float cd, sd;
    cos_sin(delta, &cd, &sd);
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

// Rocket: state (r[3], v[3], q[4], w[3]), thrust vector clamped to +-400
// inside the step, params (Jx, Jy, Jz, mass, l), dt = 0.1; the
// normalize_quat=False step (the reference's un-normalized return;
// RocketNorm renormalizes).
struct Rocket {
  static constexpr int NX = 13;
  static constexpr int NU = 3;
  static constexpr int NP = 5;
  static constexpr bool kColumnwiseQ = false;
  static constexpr float kDtR = 0.1f;
  float Jx, Jy, Jz, mass, l;

  DILQR_HD void load(const float* p) {
    Jx = p[0];
    Jy = p[1];
    Jz = p[2];
    mass = p[3];
    l = p[4];
  }

  // c[i][j] of the direction-cosine matrix C_B_I; the step uses its
  // transpose, R[i][j] = c[j][i]
  template <class S>
  DILQR_HD static void dcm(S q0, S q1, S q2, S q3, S c[3][3]) {
    c[0][0] = 1.0f - 2.0f * (q2 * q2 + q3 * q3);
    c[0][1] = 2.0f * (q1 * q2 + q0 * q3);
    c[0][2] = 2.0f * (q1 * q3 - q0 * q2);
    c[1][0] = 2.0f * (q1 * q2 - q0 * q3);
    c[1][1] = 1.0f - 2.0f * (q1 * q1 + q3 * q3);
    c[1][2] = 2.0f * (q2 * q3 + q0 * q1);
    c[2][0] = 2.0f * (q1 * q3 + q0 * q2);
    c[2][1] = 2.0f * (q2 * q3 - q0 * q1);
    c[2][2] = 1.0f - 2.0f * (q1 * q1 + q2 * q2);
  }

  // x' = step(x, u): S is float or Dual; kClamp: the thrust clamped to
  // +-400, or not
  template <bool kClamp = true, class S>
  DILQR_HD void step(const S* xs, const S* us, S* xn) const {
    S Tb[3];
    for (int i = 0; i < 3; ++i) Tb[i] = clamp_if<kClamp>(us[i], -400.0f, 400.0f);
    const S q0 = xs[6], q1 = xs[7], q2 = xs[8], q3 = xs[9];
    const S w0 = xs[10], w1 = xs[11], w2 = xs[12];
    S c[3][3];
    dcm(q0, q1, q2, q3, c);
    S dx[NX];
    dx[0] = xs[3];
    dx[1] = xs[4];
    dx[2] = xs[5];
    const float g[3] = {-10.0f, 0.0f, 0.0f};
    for (int i = 0; i < 3; ++i)
      dx[3 + i] = (c[0][i] * Tb[0] + c[1][i] * Tb[1] + c[2][i] * Tb[2]) / mass + g[i];
    dx[6] = 0.5f * (-w0 * q1 - w1 * q2 - w2 * q3);
    dx[7] = 0.5f * (w0 * q0 + w2 * q2 - w1 * q3);
    dx[8] = 0.5f * (w1 * q0 - w2 * q1 + w0 * q3);
    dx[9] = 0.5f * (w2 * q0 + w1 * q1 - w0 * q2);
    const float a = -0.5f * l;
    const S tq1 = -a * Tb[2];
    const S tq2 = a * Tb[1];
    const S cw0 = w1 * (Jz * w2) - w2 * (Jy * w1);
    const S cw1 = w2 * (Jx * w0) - w0 * (Jz * w2);
    const S cw2 = w0 * (Jy * w1) - w1 * (Jx * w0);
    dx[10] = (0.0f - cw0) / Jx;
    dx[11] = (tq1 - cw1) / Jy;
    dx[12] = (tq2 - cw2) / Jz;
    for (int i = 0; i < NX; ++i) xn[i] = xs[i] + dx[i] * kDtR;
  }

  // D = [dx'/dx | dx'/du] of the un-clamped step, [13][16]: a float[13][16]
  // or a DenseMat<13, 16> (every entry is written, the zeros first)
  template <class Out>
  DILQR_HD void jac(const float* xs, const float* us, Out&& D) const {
    const float dt = kDtR;
    const float q0 = xs[6], q1 = xs[7], q2 = xs[8], q3 = xs[9];
    const float w0 = xs[10], w1 = xs[11], w2 = xs[12];
    const float T0 = us[0], T1 = us[1], T2 = us[2];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX + NU; ++j) D[i][j] = 0.0f;
    float c[3][3];
    dcm(q0, q1, q2, q3, c);
    // dc[e][k]: partial of c entry e = 3 * row + col by q_k
    const float dc[9][4] = {
        {0.0f, 0.0f, -4.0f * q2, -4.0f * q3},
        {2.0f * q3, 2.0f * q2, 2.0f * q1, 2.0f * q0},
        {-2.0f * q2, 2.0f * q3, -2.0f * q0, 2.0f * q1},
        {-2.0f * q3, 2.0f * q2, 2.0f * q1, -2.0f * q0},
        {0.0f, -4.0f * q1, 0.0f, -4.0f * q3},
        {2.0f * q1, 2.0f * q0, 2.0f * q3, 2.0f * q2},
        {2.0f * q2, 2.0f * q3, 2.0f * q0, 2.0f * q1},
        {-2.0f * q1, -2.0f * q0, 2.0f * q3, 2.0f * q2},
        {0.0f, -4.0f * q1, -4.0f * q2, 0.0f},
    };
#pragma unroll
    for (int i = 0; i < 3; ++i) {  // r' = r + dt v
      D[i][i] = 1.0f;
      D[i][3 + i] = dt;
    }
#pragma unroll
    for (int m = 0; m < 3; ++m) {  // v' = v + dt (R T / mass + g)
      const int i = 3 + m;
      D[i][i] = 1.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        D[i][6 + k] = dt * (dc[m][k] * T0 + dc[3 + m][k] * T1 + dc[6 + m][k] * T2) / mass;
#pragma unroll
      for (int j = 0; j < 3; ++j) D[i][13 + j] = dt * c[j][m] / mass;
    }
    const float h = 0.5f * dt;  // q' = q + 0.5 dt Omega(w) q
    const float dqq[4][4] = {
        {0.0f, -h * w0, -h * w1, -h * w2},
        {h * w0, 0.0f, h * w2, -h * w1},
        {h * w1, -h * w2, 0.0f, h * w0},
        {h * w2, h * w1, -h * w0, 0.0f},
    };
    const float dqw[4][3] = {
        {-h * q1, -h * q2, -h * q3},
        {h * q0, -h * q3, h * q2},
        {h * q3, h * q0, -h * q1},
        {-h * q2, h * q1, h * q0},
    };
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) D[6 + a][6 + b] = dqq[a][b] + (a == b ? 1.0f : 0.0f);
#pragma unroll
      for (int b = 0; b < 3; ++b) D[6 + a][10 + b] = dqw[a][b];
    }
    const float kzy = Jz - Jy, kxz = Jx - Jz, kyx = Jy - Jx;  // w' = w + dt (torque - w x J w) / J
    D[10][10] = 1.0f;
    D[10][11] = -dt * kzy * w2 / Jx;
    D[10][12] = -dt * kzy * w1 / Jx;
    D[11][10] = -dt * kxz * w2 / Jy;
    D[11][11] = 1.0f;
    D[11][12] = -dt * kxz * w0 / Jy;
    D[11][15] = dt * (0.5f * l) / Jy;
    D[12][10] = -dt * kyx * w1 / Jz;
    D[12][11] = -dt * kyx * w0 / Jz;
    D[12][12] = 1.0f;
    D[12][14] = -dt * (0.5f * l) / Jz;
  }
};

// Complex pendulum (pendulum.make(simple=False)): state (cos th, sin th,
// th_dot), torque clamped to +-2, params (g, m, l, d, b) with the damping d
// and the gravity bias b. The damping term -d th needs the absolute angle,
// so the step recovers it with atan2 (the JAX kernel's Mosaic polynomial
// _poly_atan2 is a TPU workaround; atan2f is the card's own) and re-embeds
// the new angle with cos_sin. No hand Jacobian: JvpJac forms it.
struct PendulumComplex {
  static constexpr int NX = 3;
  static constexpr int NU = 1;
  static constexpr int NP = 5;
  static constexpr bool kColumnwiseQ = false;
  float g, m, l, d, b;

  DILQR_HD void load(const float* p) {
    g = p[0];
    m = p[1];
    l = p[2];
    d = p[3];
    b = p[4];
  }

  template <bool kClamp = true, class S>
  DILQR_HD void step(const S* xs, const S* us, S* xn) const {
    const S uu = clamp_if<kClamp>(us[0], -2.0f, 2.0f);
    const S c = xs[0], s = xs[1], w = xs[2];
    const S th = atan2_s(s, c);
    S cb, sb;  // (cos, sin)(th + b)
    cos_sin_s(th + b, &cb, &sb);
    const S newdth =
        w + kDt * (-3.0f * g / (2.0f * l) * (-sb) + 3.0f * uu / (m * (l * l)) - d * th);
    const S newth = th + newdth * kDt;
    cos_sin_s(newth, &xn[0], &xn[1]);
    xn[2] = newdth;
  }
};

// The rocket with normalize_quat=True: Rocket's step, then the quaternion
// divided by sqrt(q . q) + 1e-8 (dilqr_tpu/models/rocket.py:116-119). No
// hand Jacobian: JvpJac forms it.
struct RocketNorm : Rocket {
  template <bool kClamp = true, class S>
  DILQR_HD void step(const S* xs, const S* us, S* xn) const {
    Rocket::step<kClamp>(xs, us, xn);
    const S nrm = sqrt_s(xn[6] * xn[6] + xn[7] * xn[7] + xn[8] * xn[8] + xn[9] * xn[9]) + 1e-8f;
#pragma unroll
    for (int i = 6; i < 10; ++i) xn[i] = xn[i] / nrm;
  }

  template <class Out>
  void jac(const float*, const float*, Out&&) const = delete;  // not Rocket's
};

// the MLP's activation ids, shared with ops/cuda/ilqr_fused.py (MLP_ACTS)
enum MlpAct { MLP_SIGMOID = 0, MLP_RELU = 1, MLP_ELU = 2 };

template <int ACT, class S>
DILQR_HD S mlp_act(S z) {
  if constexpr (ACT == MLP_SIGMOID) {
    return sigmoid_s(z);
  } else if constexpr (ACT == MLP_RELU) {
    return relu_s(z);
  } else {
    return elu_s(z);
  }
}

// The derivative of the activation ACT at the pre-activation a, as the
// Dual forms of mlp_act take it: sigmoid s (1 - s), relu 1 above 0 (0 at
// 0), elu 1 above 0 and e^a below.
template <int ACT, class S>
DILQR_HD S mlp_act_grad(S a) {
  if constexpr (ACT == MLP_SIGMOID) {
    const S s = sigmoid_s(a);
    return s * (1.0f - s);
  } else if constexpr (ACT == MLP_RELU) {
    return a > 0.0f ? S(1.0f) : S(0.0f);
  } else {
    return a > 0.0f ? S(1.0f) : expm1_s(a) + 1.0f;
  }
}

// The learned model with its widths fixed (nn_dynamics.make(..., hidden_sizes=
// (H...))): x' = MLP(x, u), plus x where Residual (the reference's
// "passthrough" flag, a residual connection -- not the slew-rate wrapper
// Passthrough<Env> below). The layers are NX + NU -> H... -> NX, each hidden
// one followed by the activation ACT (MlpAct). The weights are the flat
// vector of nn_dynamics.flat_params (JAX's ravel_pytree order: each layer's
// W [out, in] row-major, then its b), the kernel's params: every example of
// a warp reads the same weight at the same moment, so they are read in
// place through the read-only cache (one transaction a warp; the learned
// cartpole model's 1,205 weights, 4.8 KB, stay in L1) at compile-time
// offsets -- no thread holds a copy. The last hidden layer is streamed:
// each of its units goes into the output rows as soon as it is activated,
// so no thread holds that layer (a net of one hidden layer holds none; the
// code is unrolled over every weight, so nn_dynamics.weight_limit keeps such
// a net to the 1,205 built and timed); an earlier hidden layer of a deeper
// net is an array per thread. Each row is summed in step_scalars' order
// (models/nn_dynamics.py:92-112): the products over the inputs in order,
// then the bias. No clamp (kClamp is ignored). A net of one hidden layer
// has its hand Jacobian (jac, the reference's grad_input), which its
// library takes under either method; otherwise JvpJac<Mlp, C> forms it.
template <int NX_, int NU_, int ACT, bool Residual, int... H>
struct Mlp {
  static constexpr int NX = NX_;
  static constexpr int NU = NU_;
  static constexpr int kLayers = sizeof...(H) + 1;
  static constexpr int kWidths[kLayers + 1] = {NX + NU, H..., NX};
  static constexpr int weights() {
    int s = 0;
    for (int l = 0; l < kLayers; ++l) s += (kWidths[l] + 1) * kWidths[l + 1];
    return s;
  }
  static constexpr int NP = weights();
  static constexpr bool kColumnwiseQ = false;
  const float* w;  // [NP]

  DILQR_HD void load(const float* p) { w = p; }

  template <bool kClamp = true, class S>
  DILQR_HD void step(const S* xs, const S* us, S* xn) const {
    S z[NX + NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) z[i] = xs[i];
#pragma unroll
    for (int r = 0; r < NU; ++r) z[NX + r] = us[r];
    layer<0, 0>(z, xs, xn);
  }

  // unit i of the layer whose weights are at W (NIN inputs a row, the
  // biases after the rows of NOUT units): the products over z in order,
  // then the bias
  template <int NIN, int NOUT, class S>
  DILQR_HD S unit(const float* W, int i, const S* z) const {
    S s = ldg_f(W + i * NIN) * z[0];
#pragma unroll
    for (int j = 1; j < NIN; ++j) s = s + ldg_f(W + i * NIN + j) * z[j];
    return s + ldg_f(W + NOUT * NIN + i);
  }

  // x'_i from output row i's value y
  template <class S>
  DILQR_HD void emit(int i, const S& y, const S* xs, S* xn) const {
    if constexpr (Residual) {
      xn[i] = y + xs[i];
    } else {
      xn[i] = y;
    }
  }

  // layer L of the net, its weights at OFF: y = W z + b, activated unless
  // it is the last, whose output (plus x where Residual) is x'
  template <int L, int OFF, class S>
  DILQR_HD void layer(const S* z, const S* xs, S* xn) const {
    constexpr int NIN = kWidths[L], NOUT = kWidths[L + 1];
    if constexpr (L + 1 == kLayers) {  // no hidden layer
#pragma unroll
      for (int i = 0; i < NX; ++i) emit(i, unit<NIN, NX>(w + OFF, i, z), xs, xn);
    } else if constexpr (L + 2 == kLayers) {  // the last hidden layer, streamed
      constexpr int OFF2 = OFF + (NIN + 1) * NOUT;  // the output layer's W [NX, NOUT]
      S s[NX];
      const S y0 = mlp_act<ACT>(unit<NIN, NOUT>(w + OFF, 0, z));
#pragma unroll
      for (int i = 0; i < NX; ++i) s[i] = ldg_f(w + OFF2 + i * NOUT) * y0;
#pragma unroll
      for (int h = 1; h < NOUT; ++h) {
        const S y = mlp_act<ACT>(unit<NIN, NOUT>(w + OFF, h, z));
#pragma unroll
        for (int i = 0; i < NX; ++i) s[i] = s[i] + ldg_f(w + OFF2 + i * NOUT + h) * y;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) emit(i, s[i] + ldg_f(w + OFF2 + NX * NOUT + i), xs, xn);
    } else {
      S y[NOUT];
#pragma unroll
      for (int i = 0; i < NOUT; ++i) y[i] = mlp_act<ACT>(unit<NIN, NOUT>(w + OFF, i, z));
      layer<L + 1, OFF + (NIN + 1) * NOUT>(y, xs, xn);
    }
  }

  // D = [dx'/dx | dx'/du] of a net of one hidden layer, the reference's
  // grad_input (dynamics.py:81-130) in the pass over the hidden units that
  // the step makes: with a_h = W1[h, :] z + b1_h (unit's order), D += W2[:, h]
  // (act'(a_h) W1[h, :]) for h in order, then I where Residual. The same
  // order as nn_dynamics' jac_lanes. Every entry of D is written, so D may
  // be registers or strided storage; S: float in the kernel, double too on
  // the host.
  template <class S, class Out>
  DILQR_HD void jac(const S* xs, const S* us, Out&& D) const {
    static_assert(kLayers == 2, "the hand Jacobian is that of one hidden layer");
    constexpr int N = NX + NU, NH = kWidths[1], OFF2 = (N + 1) * NH;
    S z[N];
#pragma unroll
    for (int i = 0; i < NX; ++i) z[i] = xs[i];
#pragma unroll
    for (int r = 0; r < NU; ++r) z[NX + r] = us[r];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) D[i][j] = S(0.0f);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const S g = mlp_act_grad<ACT>(unit<N, NH>(w, h, z));
      S t[N];
#pragma unroll
      for (int j = 0; j < N; ++j) t[j] = g * ldg_f(w + h * N + j);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const S w2 = ldg_f(w + OFF2 + i * NH + h);
#pragma unroll
        for (int j = 0; j < N; ++j) D[i][j] = D[i][j] + w2 * t[j];
      }
    }
    if constexpr (Residual) {
#pragma unroll
      for (int i = 0; i < NX; ++i) D[i][i] = D[i][i] + S(1.0f);
    }
  }
};

// A user's own model (a Dynamics with neither device code nor MLP
// widths), its step and linearization point traced by torch.fx and
// generated as straight-line C++ (ops/cuda/traced.py): M is the generated
// traced::Model, whose step<S, P>(x, u, p, x') and step_unclamped<S, P>
// (the model's linearize_point) are templates over the scalar S (float,
// or a Dual for the jvp sweep) and the params' type P. The params are read
// in place through the read-only cache at each evaluation, as Mlp's
// weights are. kClamp: the step (GradMethod.AUTO_DIFF's, and the rollout's)
// or the linearization point (ANALYTIC). No hand Jacobian: JvpJac<Traced,
// C> forms it, as the JAX kernel's lin_at does for a user's model.
template <class M>
struct Traced {
  static constexpr int NX = M::NX;
  static constexpr int NU = M::NU;
  static constexpr int NP = M::NP;
  static constexpr bool kColumnwiseQ = false;
  const float* p;

  DILQR_HD void load(const float* params) { p = params; }

  template <bool kClamp = true, class S>
  DILQR_HD void step(const S* xs, const S* us, S* xn) const {
    if constexpr (kClamp) {
      M::step(xs, us, p, xn);
    } else {
      M::step_unclamped(xs, us, p, xn);
    }
  }
};

// The Jacobian by forward mode, as the JAX kernel's jvp sweep forms it
// (lin_at, dilqr_tpu/ops/pallas/ilqr_fused.py:1258-1266): Env's step
// evaluated on Duals n = NX + NU times, column j with the one-hot tangent
// e_j (x's columns 0..NX-1, then u's), D[i][j] the tangent of x'_i. Clamped:
// the clamped step (GradMethod.AUTO_DIFF: a saturated control's column is
// exactly 0, torch.clamp's convention) or the un-clamped physics (ANALYTIC,
// an env with no hand Jacobian). The n evaluations share the step's
// values, which the unrolled loop computes once; each carries one tangent.
// Every entry of D is written, so D may be registers or strided storage.
template <class Env, bool Clamped>
struct JvpJac {
  static constexpr int NX = Env::NX;
  static constexpr int NU = Env::NU;
  static constexpr int NP = Env::NP;
  static constexpr bool kColumnwiseQ = Env::kColumnwiseQ;
  Env env;

  DILQR_HD void load(const float* p) { env.load(p); }

  template <bool kClamp = true, class S>
  DILQR_HD void step(const S* xs, const S* us, S* xn) const {
    env.template step<kClamp>(xs, us, xn);
  }

  template <class Out>
  DILQR_HD void jac(const float* xs, const float* us, Out&& D) const {
#pragma unroll
    for (int j = 0; j < NX + NU; ++j) {
      Dual xd[NX], ud[NU], xn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xd[i] = Dual(xs[i], i == j ? 1.0f : 0.0f);
#pragma unroll
      for (int r = 0; r < NU; ++r) ud[r] = Dual(us[r], NX + r == j ? 1.0f : 0.0f);
      env.template step<Clamped>(xd, ud, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) D[i][j] = xn[i].d;
    }
  }
};

// Views that shift a matrix's indices: row i of ShiftRows is row i + R of
// the underlying D, column j is column j + R. The slew-rate wrapper writes
// its base env's Jacobian through one into the lower-right block.
template <class Row, int R>
struct ShiftCols {
  Row row;
  DILQR_HD float& operator[](int j) const { return row[j + R]; }
};
template <class Out, int R>
struct ShiftRows {
  Out& D;
  DILQR_HD auto operator[](int i) const {
    return ShiftCols<decltype(D[0]), R>{D[i + R]};
  }
};

// The slew-rate augmented state (u_{t-1}, x) of an env (counterpart of
// models/ctrl_passthrough.py): the step is (u, step(x, u)); the Jacobian
// over ((u_{t-1}, x), u) has rows [0 | 0 | I] for the u_{t-1} block and
// [0 | Fx | Fu] below, from the env's own (hand-derived, or JvpJac's).
// The JAX kernel forms this matrix with a jvp sweep (lin_at); the entries
// agree up to the rounding of the env's Jacobian against its jvp.
template <class Env>
struct Passthrough {
  static constexpr int NU = Env::NU;
  static constexpr int NX = NU + Env::NX;
  static constexpr int NP = Env::NP;
  static constexpr bool kColumnwiseQ = true;
  Env env;

  DILQR_HD void load(const float* p) { env.load(p); }

  DILQR_HD void step(const float* xs, const float* us, float* xn) const {
#pragma unroll
    for (int r = 0; r < NU; ++r) xn[r] = us[r];
    env.step(xs + NU, us, xn + NU);
  }

  template <class Out>
  DILQR_HD void jac(const float* xs, const float* us, Out&& D) const {
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int j = 0; j < NX + NU; ++j) D[r][j] = j == NX + r ? 1.0f : 0.0f;
#pragma unroll
    for (int i = NU; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) D[i][j] = 0.0f;
    // the env's [Fx | Fu] at rows and columns NU..: x's columns follow
    // u_{t-1}'s, and u's follow x's
    env.jac(xs + NU, us, ShiftRows<Out, NU>{D});
  }
};

// The dynamics of a time-varying affine (LQR) problem as data (LinDx in
// dilqr_tpu_torch/types.py; the JAX kernel's F/f lane inputs,
// ilqr_fused.py:1166-1176 and :1269-1270): the step x' = F_t tau + f_t,
// each row summed over the columns j = 0..N-1 in order, and the Jacobian
// F_t itself. F is [T-1, NX*N, Bp] and f [T-1, NX, Bp] or null, each
// example its own column: bind() takes this example's, at(t) seats step
// t's slab. There is no F at T-1: the kernel takes no step after the last
// one and forms Q = C there. Read through the read-only cache.
template <int NX_, int NU_>
struct LinDx {
  static constexpr int NX = NX_;
  static constexpr int NU = NU_;
  static constexpr int N = NX + NU;
  static constexpr int NP = 0;
  static constexpr bool kColumnwiseQ = true;
  const float* F0;  // step 0's entries of this example, `stride` apart
  const float* f0;  // or null
  int stride;
  const float* Ft;  // step t's
  const float* ft;

  DILQR_HD void load(const float*) {}

  DILQR_HD void bind(const float* F, const float* f, int Bp, int b) {
    F0 = F + b;
    f0 = f ? f + b : nullptr;
    stride = Bp;
  }

  DILQR_HD void at(int t) {
    Ft = F0 + (size_t)t * NX * N * stride;
    ft = f0 ? f0 + (size_t)t * NX * stride : nullptr;
  }

  DILQR_HD float Fe(int i, int j) const { return ldg_f(Ft + (size_t)(i * N + j) * stride); }

  DILQR_HD void step(const float* xs, const float* us, float* xn) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) s += Fe(i, j) * xs[j];
#pragma unroll
      for (int j = 0; j < NU; ++j) s += Fe(i, NX + j) * us[j];
      xn[i] = ft ? s + ldg_f(ft + (size_t)i * stride) : s;
    }
  }

  // D = F_t, [NX][N]: a float[NX][N] or any view indexed D[i][j]
  template <class Out>
  DILQR_HD void jac(const float*, const float*, Out&& D) const {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) D[i][j] = Fe(i, j);
  }
};

// envs whose dynamics are data (bind, at): the kernel seats the step
template <class Env>
constexpr bool kDataEnv = false;
template <int NX, int NU>
constexpr bool kDataEnv<LinDx<NX, NU>> = true;

// ---- the multi-control box-QP of the Riccati step (nu = 2..8) ----
// Counterparts of _inv_lanes and _pnqp_lanes in dilqr_tpu/ops/pallas/
// ilqr_fused.py, with its constants.
constexpr float kPnqpReg = 1e-11f;
constexpr float kPnqpGamma = 0.1f;
constexpr float kPnqpDecay = 0.1f;
constexpr float kPnqpConv = 1e-4f;
constexpr int kPnqpArmijoIter = 10;
// examples that no longer step carry this armijo value (the reference quirk)
constexpr float kPnqpSentinel = (float)(0.1 + 1e-6);

// Explicit inverse of a small SPD-plus-ridge matrix, M <= kMaxNu:
// reciprocal, Cramer, adjugate over the determinant for M <= 3, unpivoted
// Gauss-Jordan for 4 <= M <= 8 (the JAX kernels' _inv_lanes,
// dilqr_tpu/ops/pallas/ilqr_fused.py:492-545, in its order: row k scaled
// by 1/pivot, then every other row i eliminated, column by column; no
// pivoting, as elimination keeps an SPD matrix's pivots positive)
template <int M>
DILQR_HD void inv_small(const float A[M][M], float R[M][M]) {
  if constexpr (M == 1) {
    R[0][0] = 1.0f / A[0][0];
  } else if constexpr (M == 2) {
    const float det = A[0][0] * A[1][1] - A[0][1] * A[1][0];
    const float r = 1.0f / det;
    R[0][0] = A[1][1] * r;
    R[0][1] = -A[0][1] * r;
    R[1][0] = -A[1][0] * r;
    R[1][1] = A[0][0] * r;
  } else if constexpr (M == 3) {
    const float c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1];
    const float c01 = A[1][2] * A[2][0] - A[1][0] * A[2][2];
    const float c02 = A[1][0] * A[2][1] - A[1][1] * A[2][0];
    const float det = A[0][0] * c00 + A[0][1] * c01 + A[0][2] * c02;
    const float r = 1.0f / det;
    const float c10 = A[0][2] * A[2][1] - A[0][1] * A[2][2];
    const float c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0];
    const float c12 = A[0][1] * A[2][0] - A[0][0] * A[2][1];
    const float c20 = A[0][1] * A[1][2] - A[0][2] * A[1][1];
    const float c21 = A[0][2] * A[1][0] - A[0][0] * A[1][2];
    const float c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0];
    R[0][0] = c00 * r; R[0][1] = c10 * r; R[0][2] = c20 * r;
    R[1][0] = c01 * r; R[1][1] = c11 * r; R[1][2] = c21 * r;
    R[2][0] = c02 * r; R[2][1] = c12 * r; R[2][2] = c22 * r;
  } else {
    static_assert(M <= kMaxNu, "Gauss-Jordan for 4 <= M <= kMaxNu");
    float a[M][M];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < M; ++j) {
        a[i][j] = A[i][j];
        R[i][j] = i == j ? 1.0f : 0.0f;
      }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const float piv = 1.0f / a[k][k];
#pragma unroll
      for (int j = 0; j < M; ++j) {
        a[k][j] = a[k][j] * piv;
        R[k][j] = R[k][j] * piv;
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i == k) continue;
        const float fct = a[i][k];
#pragma unroll
        for (int j = 0; j < M; ++j) {
          a[i][j] = a[i][j] - fct * a[k][j];
          R[i][j] = R[i][j] - fct * R[k][j];
        }
      }
    }
  }
}

// y = A x
template <int M>
DILQR_HD void mv_small(const float A[M][M], const float* x, float* y) {
  for (int i = 0; i < M; ++i) {
    float s = 0.0f;
    for (int j = 0; j < M; ++j) s += A[i][j] * x[j];
    y[i] = s;
  }
}

// the QP objective 0.5 x^T H x + q^T x
template <int M>
DILQR_HD float qp_obj(const float H[M][M], const float* q, const float* x) {
  float Hx[M];
  mv_small<M>(H, x, Hx);
  float quad = 0.0f, lin = 0.0f;
  for (int i = 0; i < M; ++i) quad += x[i] * Hx[i];
  for (int i = 0; i < M; ++i) lin += q[i] * x[i];
  return 0.5f * quad + lin;
}

// One projected-Newton step at x: the gradient g, the free set If (0 on
// the active set (x <= lb & g > 0) | (x >= ub & g < 0)), the masked and
// ridged Hessian Hf = H * If If^T + 1e-11 I and the direction
// dx = -Hf^{-1} (g * If).
template <int M>
DILQR_HD void pnqp_newton(const float H[M][M], const float* q, const float* lb,
                          const float* ub, const float* x, float* g, float* If,
                          float Hf[M][M], float* dx) {
  mv_small<M>(H, x, g);
  for (int i = 0; i < M; ++i) {
    g[i] += q[i];
    const bool Ic = (x[i] <= lb[i] && g[i] > 0.0f) || (x[i] >= ub[i] && g[i] < 0.0f);
    If[i] = Ic ? 0.0f : 1.0f;
  }
  for (int i = 0; i < M; ++i)
    for (int j = 0; j < M; ++j) Hf[i][j] = H[i][j] * If[i] * If[j] + (i == j ? kPnqpReg : 0.0f);
  float Hi[M][M], gf[M];
  inv_small<M>(Hf, Hi);
  for (int i = 0; i < M; ++i) gf[i] = g[i] * If[i];
  mv_small<M>(Hi, gf, dx);
  for (int i = 0; i < M; ++i) dx[i] = -dx[i];
}

// The box-QP min 0.5 x^T H x + q^T x, lb <= x <= ub, from x0 (clipped),
// with the tile's decisions as votes: the Newton loop ends when no example
// of the tile still steps (||dx|| >= 1e-4); the Armijo backtracking (alpha
// x 0.1 where armijo <= 0.1, at most 10 trials) goes on while every
// example's armijo is <= 0.1 -- a NaN anywhere ends it, as a max does.
// Returns x and the If/Hf of the last Newton step (taken at the iterate
// before the last Armijo step, or at x0 when the loop does not run): the
// Riccati step forms its gains from those. `vote` is the tile's (TileVote).
template <int M>
DILQR_HD void pnqp(const float H[M][M], const float* q, const float* lb, const float* ub,
                   const float* x0, int n_iter, TileVote& vote, float* x, float* If,
                   float Hf[M][M]) {
  for (int i = 0; i < M; ++i) x[i] = clip(x0[i], lb[i], ub[i]);
  float g[M], dx[M];
  pnqp_newton<M>(H, q, lb, ub, x, g, If, Hf, dx);
  for (int it = 0; it < n_iter; ++it) {
    if (it > 0) pnqp_newton<M>(H, q, lb, ub, x, g, If, Hf, dx);
    float n2 = 0.0f;
    for (int i = 0; i < M; ++i) n2 += dx[i] * dx[i];
    const bool J = sqrtf(n2) >= kPnqpConv;
    if (!vote.any(J)) break;  // the tile is done: x stays
    const float ox = qp_obj<M>(H, q, x);
    float alpha = 1.0f, mx[M];
    for (int k = 0; k < kPnqpArmijoIter; ++k) {
      float den = 0.0f;
      for (int i = 0; i < M; ++i) mx[i] = clip(x[i] + alpha * dx[i], lb[i], ub[i]);
      for (int i = 0; i < M; ++i) den += g[i] * (x[i] - mx[i]);
      const float arm = J ? (ox - qp_obj<M>(H, q, mx)) / den : kPnqpSentinel;
      if (arm <= kPnqpGamma) alpha *= kPnqpDecay;
      if (vote.any(!(arm <= kPnqpGamma))) break;
    }
    for (int i = 0; i < M; ++i) x[i] = mx[i];
  }
}

// One step's cost of one example: C row-major [N*N] and c [N], their
// entries `stride` apart -- 1 for the example-invariant cost, the padded
// batch for the per-example one ([T, N*N, Bp], each example its own
// column). Read through the read-only cache.
struct CostView {
  const float* C;
  const float* c;
  int stride;
  DILQR_HD float Ce(int e) const { return ldg_f(C + (size_t)e * stride); }
  DILQR_HD float ce(int i) const { return ldg_f(c + (size_t)i * stride); }
  // (C tau + c)_i, the delta-space shift of the Riccati step's q
  template <int N>
  DILQR_HD float shift(int i, const float* tau) const {
    float cb = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) cb += Ce(i * N + j) * tau[j];
    return cb + ce(i);
  }
};

// A callable cost's quadratic model at tau (the JAX kernel's quad_at,
// dilqr_tpu/ops/pallas/ilqr_fused.py:1063-1080): its Hessian H, kept as the
// upper triangle, in place of C, and its gradient g in place of the shift
// C tau + c (in delta space C tau + c collapses to g, :1285-1289). Read as
// a CostView is, so the Riccati step takes either.
template <int N, class T = float>
struct CostQuad {
  T h[N * (N + 1) / 2];
  T g[N];
  DILQR_HD T Ce(int e) const {
    const int i = e / N, j = e % N;
    return h[i <= j ? i * N - i * (i - 1) / 2 + (j - i) : j * N - j * (j - 1) / 2 + (i - j)];
  }
  template <int M>
  DILQR_HD T shift(int i, const T*) const { return g[i]; }
};

// (H, g) of Cost at tau by forward over forward: Cost::cost on
// DualOf<Dual> once for each i <= j, tau + e_i eps1 + e_j eps2, whose
// (eps1 eps2) part is H[i][j] and whose eps1 part at i == j is g[i] -- the
// same derivatives as JAX's n jvps for g and n of the gradient map for H.
// cp: the cost's params [Cost::NP]. T: float on the card (double in a
// host build).
template <class Cost, int N, class T = float>
DILQR_HD CostQuad<N, T> quad_at(const T* tau, const T* cp) {
  using DT = DualOf<T>;
  using DD = DualOf<DT>;
  CostQuad<N, T> q;
  int e = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j, ++e) {
      DD td[N];
#pragma unroll
      for (int k = 0; k < N; ++k)
        td[k] = DD(DT(tau[k], T(k == i ? 1 : 0)), DT(T(k == j ? 1 : 0), T(0)));
      const DD r = Cost::cost(td, cp);
      q.h[e] = r.d.d;
      if (i == j) q.g[i] = r.v.d;
    }
  }
  return q;
}

// 0.5 tau^T C tau + c^T tau for tau = (x, u)
template <int N>
DILQR_HD float objective(const float* tau, const CostView& cost) {
  float quad = 0.0f, lin = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float ct = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) ct += cost.Ce(i * N + j) * tau[j];
    quad += tau[i] * ct;
    lin += cost.ce(i) * tau[i];
  }
  return 0.5f * quad + lin;
}

// The step's variants, each the same for the whole launch: the bounds'
// delta_u trust region (has_du), and the u_zero_I mask of an unboxed
// solve (masked, with the step's mask Iz as 0/1 floats), whose gains come
// from the free subspace instead of the box-QP. Held by value: a pointer
// chosen at run time would put the mask in local memory.
template <int NU>
struct StepVariant {
  int has_du;
  float du;
  int masked;
  float Iz[NU];
};

// ---- the Riccati step over strided storage (nu = 2..8; nu = 1 past
// kRegisterNx states) ----
// One example's V and Q sit in strided storage: on the device
// [entry][example] in the block's shared memory, so none of them is in
// local memory; v, q, the gains and one block of columns of V F are
// registers. V and Q are kept as their upper triangles. Where V, Q and F
// together let two blocks of 128 examples share an SM (kTwoBlockFloats),
// F is dense in the store too (the whole layout). Past that (the split
// layout: the rocket, its slew-rate wrapper, the larger LinDx, MLP and
// traced shapes) F leaves the store for a scratch of the launch in device
// memory, [entry][example] a block as the store is (a LinDx's F too: read
// in place, at the data's run-time stride, it spilled 2.9 KB on LinDx (15,
// 2)), and so does Q's Quu block, which is the box-QP's Hessian and is
// formed in registers; q waits in the scratch while Q is formed.

// columns of V F formed together: each V entry is read once per block
constexpr int kColBlock = 4;

// A store to and a load from device memory that the compiler keeps where
// they stand (inline PTX): it neither carries the value in a register
// between them nor moves them. The split layout parks q in the scratch
// with these while Q is formed; plain accesses were forwarded into
// registers, which ptxas then spilled (measured: 432 bytes of stack on the
// rocket).
DILQR_HD void store_kept(float* p, float v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.global.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
#else
  *p = v;
#endif
}
DILQR_HD float load_kept(const float* p) {
#ifdef __CUDA_ARCH__
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
#else
  return *p;
#endif
}

// p, through a move the compiler cannot see through: a pointer formed from
// it inside a loop is formed there again, not held in registers across the
// loop
DILQR_HD float* opaque(float* p) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.b64 %0, %0;" : "+l"(p));
#endif
  return p;
}

// Floats an example may take in the store for two blocks of 128 examples
// (whole warps, kMaxWarps) to share an SM: a Hopper SM has 233,472 bytes
// of shared memory and keeps 1,024 of them a block, and a block's vote
// words (2 x kMaxWarps) are static shared memory beside the store: 225.
constexpr int kSmemPerSm = 233472;
constexpr int kSmemReservedPerBlock = 1024;
constexpr int kTwoBlockFloats =
    (kSmemPerSm / 2 - kSmemReservedPerBlock - 2 * kMaxWarps * (int)sizeof(unsigned)) /
    ((int)sizeof(float) * 32 * kMaxWarps);

// the offsets (in entries) of V, Q and F in one example's storage; kF is -1
// in the split layout, whose F is in the scratch and whose Q ends before its
// Quu block (the last entries of the triangle)
template <class Env, int NU>
struct BoxStepLayout {
  static constexpr int NX = Env::NX;
  static constexpr int N = NX + NU;
  static constexpr int kWhole = SymMat<NX>::kSize + SymMat<N>::kSize + NX * N;
  static constexpr bool kSplit = kWhole > kTwoBlockFloats;
  static constexpr int kV = 0;
  static constexpr int kQ = kV + SymMat<NX>::kSize;
  static constexpr int kF = kSplit ? -1 : kQ + SymMat<N>::kSize;
  static constexpr int kFloats = kSplit ? kQ + SymMat<N>::kSize - SymMat<NU>::kSize : kWhole;
  // floats an example of the launch's scratch: F, then q while Q is formed
  static constexpr int kScratch = kSplit ? NX * N + N : 0;
};

// One reverse Riccati step at tau = (x_t, u_t), the arithmetic of the JAX
// kernel's step (ilqr_fused.py:1224-1384): F = jac(tau) (at t = T-1, where
// V, v and F are zero, Q = C and q = C tau + c exactly), Q = C + F^T (V F)
// and q = C tau + c + F^T v, the box-QP in delta space (bounds lo - u, hi
// - u, intersected with +-delta_u) warm-started with `warm` (k_{t+1}; at
// T-1 the clipped ridged Newton point), the gains K = -inv(H_free) (Q_ux *
// If) and k, and the update V' = Qxx + M + M^T + K^T Quu K (M = Qxu K), v'
// = qx + Qxu k + K^T (qu + Quu k). `cost` is a CostView or, for a callable
// cost, its CostQuad (H in place of C, g in place of C tau + c). An unboxed
// solve with a u_zero_I mask
// (var.masked) takes the free subspace instead (:1313-1334): If = 1 - Iz,
// H_free = Quu * If If^T + 1e-8 diag(Iz), k = -inv(H_free) (qu * If), and
// no box-QP. One control takes the closed-form 1-D QP (or, masked, k =
// -(qu If) / Quu) instead. V and v are read and overwritten; `store` holds V and Q (and F
// in the whole layout) with `stride` between entries (BoxStepLayout), `fscratch` F and q
// with `fstride` between entries in the split layout (else unused); lo/hi are this step's
// bounds. The layouts hold the same numbers and sum
// them in the same order. Where `quu` points somewhere (the tests), it receives Quu,
// [NU][NU] row-major, as the box-QP takes it.
template <class Env, int NU, class Cost = CostView>
DILQR_HD void riccati_box_step(const Env& env, bool last, const float* tau, const Cost& cost,
                               const float* lo, const float* hi, const StepVariant<NU>& var,
                               const float* warm, int pnqp_iter, TileVote& vote, float* store,
                               int stride, float* fscratch, int fstride, float* v,
                               float K[NU][Env::NX], float* kt, Strided quu = {nullptr, 0}) {
  using L = BoxStepLayout<Env, NU>;
  constexpr int NX = Env::NX;
  constexpr int N = NX + NU;
  const SymMat<NX> V{{store + L::kV * stride, stride}};
  const SymMat<N> Q{{store + L::kQ * stride, stride}};
  const DenseMat<NX, N> F{L::kSplit ? Strided{fscratch, fstride}
                                     : Strided{store + L::kF * stride, stride}};
  // Q's entry (i, j), i <= j: Quu in H (the box-QP's Hessian, mirrored) in
  // the split layout, else in the store
  float H[NU][NU];
  auto put_q = [&](int i, int j, float e) {
    if (L::kSplit && i >= NX) {
      H[i - NX][j - NX] = e;
      H[j - NX][i - NX] = e;
    } else {
      Q(i, j) = e;
    }
  };

  // q: C tau + c (a callable cost's g) here, F^T v added below; in the
  // split layout in the scratch after F until Q is formed
  float q[N];
  float* const qs = fscratch + NX * N * fstride;
  auto put_qv = [&](int i, float e) {
    if constexpr (L::kSplit) {
      store_kept(qs + i * fstride, e);
    } else {
      q[i] = e;
    }
  };
  auto get_qv = [&](int i) -> float {
    if constexpr (L::kSplit) {
      return load_kept(qs + i * fstride);
    } else {
      return q[i];
    }
  };
#pragma unroll
  for (int i = 0; i < N; ++i) put_qv(i, cost.template shift<N>(i, tau));
  if (last) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = i; j < N; ++j) put_q(i, j, cost.Ce(i * N + j));
  } else {
    env.jac(tau, tau + NX, F);
#pragma unroll
    for (int j0 = 0; j0 < N; j0 += kColBlock) {
      float tmp[kColBlock][NX];  // columns j0.. of V F
#pragma unroll
      for (int jj = 0; jj < kColBlock; ++jj)
#pragma unroll
        for (int k = 0; k < NX; ++k) tmp[jj][k] = 0.0f;
#pragma unroll
      for (int m = 0; m < NX; ++m) {
        float f[kColBlock];
#pragma unroll
        for (int jj = 0; jj < kColBlock; ++jj) f[jj] = j0 + jj < N ? F[m][j0 + jj] : 0.0f;
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const float vmk = V(m, k);
#pragma unroll
          for (int jj = 0; jj < kColBlock; ++jj) tmp[jj][k] += vmk * f[jj];
        }
      }
      // Q's entries (i, j) of these columns with i <= j, and F^T v for
      // the rows i of this block
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i >= j0 + kColBlock) continue;
        float fi[NX];
#pragma unroll
        for (int k = 0; k < NX; ++k) fi[k] = F[k][i];
#pragma unroll
        for (int jj = 0; jj < kColBlock; ++jj) {
          const int j = j0 + jj;
          if (j >= N || i > j) continue;
          float s = 0.0f;
#pragma unroll
          for (int k = 0; k < NX; ++k) s += fi[k] * tmp[jj][k];
          put_q(i, j, cost.Ce(i * N + j) + s);
        }
        if (i >= j0) {
          float fv = 0.0f;
#pragma unroll
          for (int k = 0; k < NX; ++k) fv += fi[k] * v[k];
          put_qv(i, get_qv(i) + fv);
        }
      }
    }
  }
  if constexpr (L::kSplit) {
#pragma unroll
    for (int i = 0; i < N; ++i) q[i] = get_qv(i);
  }

  // the box-QP in delta space
  float qu[NU], lb[NU], ub[NU], w[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) {
    qu[r] = q[NX + r];
    lb[r] = lo[r] - tau[NX + r];
    ub[r] = hi[r] - tau[NX + r];
    if (var.has_du) {  // the trust region intersected into the QP bounds
      lb[r] = maximum(lb[r], -var.du);
      ub[r] = minimum(ub[r], var.du);
    }
    if constexpr (!L::kSplit) {
#pragma unroll
      for (int s = 0; s < NU; ++s) H[r][s] = Q(NX + r, NX + s);
    }
    if (quu.p) {
#pragma unroll
      for (int s = 0; s < NU; ++s) quu[r * NU + s] = H[r][s];
    }
  }
  float If[NU], Hf[NU][NU], Hinv[NU][NU];
  if constexpr (NU == 1) {
    // one control (a LinDx problem past kRegisterNx states): the register
    // path's exact closed-form 1-D box-QP, no vote; masked, the free
    // subspace with k over the unmasked Quu (the reference's quirk,
    // :1328-1331)
    const float h = H[0][0];
    if (var.masked) {
      If[0] = 1.0f - var.Iz[0];
      kt[0] = -(qu[0] * If[0]) / h;
      Hinv[0][0] = 1.0f / (h * If[0] * If[0] + 1e-8f * var.Iz[0]);
    } else {
      kt[0] = clip(-qu[0] / h, lb[0], ub[0]);
      const float g = h * kt[0] + qu[0];
      const bool Ic = (kt[0] <= lb[0] && g > 0.0f) || (kt[0] >= ub[0] && g < 0.0f);
      If[0] = Ic ? 0.0f : 1.0f;
      Hinv[0][0] = 1.0f / (h * If[0] + 1e-11f);
    }
  } else if (var.masked) {
    // the free subspace of an unboxed masked solve; no box-QP, no vote
    float qf[NU];
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      If[r] = 1.0f - var.Iz[r];
      qf[r] = qu[r] * If[r];
    }
#pragma unroll
    for (int r = 0; r < NU; ++r)
#pragma unroll
      for (int s = 0; s < NU; ++s)
        Hf[r][s] = H[r][s] * If[r] * If[s] + (r == s ? 1e-8f * var.Iz[r] : 0.0f);
    inv_small<NU>(Hf, Hinv);
    mv_small<NU>(Hinv, qf, kt);
#pragma unroll
    for (int r = 0; r < NU; ++r) kt[r] = -kt[r];
  } else {
    if (!last) {
#pragma unroll
      for (int r = 0; r < NU; ++r) w[r] = warm[r];
    } else {
      // clip(-inv(Quu + 1e-11 I) qu, lb, ub)
      float Hr[NU][NU], Hri[NU][NU];
#pragma unroll
      for (int r = 0; r < NU; ++r)
#pragma unroll
        for (int s = 0; s < NU; ++s) Hr[r][s] = H[r][s] + (r == s ? kPnqpReg : 0.0f);
      inv_small<NU>(Hr, Hri);
      mv_small<NU>(Hri, qu, w);
#pragma unroll
      for (int r = 0; r < NU; ++r) w[r] = clip(-w[r], lb[r], ub[r]);
    }
    pnqp<NU>(H, qu, lb, ub, w, pnqp_iter, vote, kt, If, Hf);
    inv_small<NU>(Hf, Hinv);
  }

  // K = -inv(H_free) (Q_ux * If): active rows of Q_ux zeroed
  float Qxu[NX][NU];
#pragma unroll
  for (int j = 0; j < NX; ++j)
#pragma unroll
    for (int r = 0; r < NU; ++r) Qxu[j][r] = Q(j, NX + r);
#pragma unroll
  for (int r = 0; r < NU; ++r)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < NU; ++m) s += Hinv[r][m] * (Qxu[j][m] * If[m]);
      K[r][j] = -s;
    }

  // the V/v update; V' on its upper triangle
  float QK[NU][NX], qk[NU];
#pragma unroll
  for (int r = 0; r < NU; ++r) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < NU; ++m) s += H[r][m] * K[m][j];
      QK[r][j] = s;
    }
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < NU; ++m) s += H[r][m] * kt[m];
    qk[r] = qu[r] + s;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = i; j < NX; ++j) {
      float mij = 0.0f, mji = 0.0f, kqk = 0.0f;
#pragma unroll
      for (int r = 0; r < NU; ++r) {
        mij += Qxu[i][r] * K[r][j];
        mji += Qxu[j][r] * K[r][i];
        kqk += K[r][i] * QK[r][j];
      }
      V(i, j) = Q(i, j) + mij + mji + kqk;
    }
    float qxk = 0.0f, kq = 0.0f;
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      qxk += Qxu[i][r] * kt[r];
      kq += K[r][i] * qk[r];
    }
    v[i] = q[i] + qxk + kq;
  }
}

}  // namespace dilqr
