"""A user's own model and a callable cost on the whole-solve kernel, traced
into C++ (dilqr_tpu_torch/ops/cuda/traced.py), on the CPU:

 * the generated code, built for the host with g++ (as
   tests/test_torch_csrc.py builds the device headers) and instantiated at
   double: the port's cartpole, pendulum and rocket steps traced as user
   models and the double pendulum of tests/test_fused_edge_cases.py:68-92
   equal their torch step at f64 within 1e-12, their Dual Jacobians equal
   torch.func.jvp column by column (the clamped step and the linearization
   point), and a callable cost's nested-Dual (H, g) (quad_at) equals
   torch.func.hessian and grad; the operation counts traced.py gives equal
   those of a host build over a counting scalar;
 * the kernel's plain version (ilqr_fused_reference) against the JAX
   package's Pallas kernel in interpret mode: the double pendulum, boxed
   and unboxed, under ANALYTIC and AUTO_DIFF, and the pendulum with the
   callable cost with and without params (tests/test_fused_edge_cases.py:
   266-313), at tests/test_torch_ilqr_fused.py's tolerances (u 2e-3, x
   5e-3, costs rtol/atol 1e-5, n_iter equal; eps=0, a few iterations);
 * the slice end to end: solve and the IFT gradient with respect to the
   dynamics params and the cost params, the double pendulum with a
   callable cost, against JAX's solve and jax.grad at f64 (rtol 1e-6 of
   the largest entry);
 * the trace cache (a second solve's dispatch traces nothing, a solve on
   the CPU never traces, an entry goes with its model or cost, a slew-rate
   wrapper's trace is its base's), a captured one-element tensor read at
   each call, and the refusals: a step that captures an array, branches on
   data, or calls an operation outside the set, f64, pytree params and a
   cost that captures an array keep the plain loop, and backend="cuda"
   raises for them."""
import ctypes
import dataclasses
import os
import shutil
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.models import pendulum as jpend
from dilqr_tpu.ops.pallas.ilqr_fused import cost_lane_compatible, lane_compatible
import dilqr_tpu_torch as P
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.core import ilqr as tilqr
from dilqr_tpu_torch.models import cartpole as tcart
from dilqr_tpu_torch.models import pendulum as tpend
from dilqr_tpu_torch.models import rocket as trock
from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused
from dilqr_tpu_torch.ops.cuda import traced
from test_fused_edge_cases import _double_pendulum_style
import traced_models as tm

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dilqr_tpu_torch", "csrc")

# ---- the generated code on the host ----

SHIM = r"""
#include <cmath>
#include "ilqr_fused.cuh"
#include "dilqr_traced.cuh"
using namespace dilqr;
using M = traced::Model;
using C = traced::Cost;
// per example: the step (clamped) or the linearization point at double,
// and its Jacobian from the same function on DualOf<double>
extern "C" void model_eval(int clamped, const double* p, const double* x, const double* u,
                           int B, double* xn, double* D) {
  constexpr int NX = M::NX, NU = M::NU, N = NX + NU;
  for (int b = 0; b < B; ++b) {
    const double* xb = x + b * NX;
    const double* ub = u + b * NU;
    if (clamped) M::step(xb, ub, p, xn + b * NX);
    else M::step_unclamped(xb, ub, p, xn + b * NX);
    for (int j = 0; j < N; ++j) {
      DualOf<double> xd[NX], ud[NU], o[NX];
      for (int i = 0; i < NX; ++i) xd[i] = DualOf<double>(xb[i], i == j ? 1.0 : 0.0);
      for (int r = 0; r < NU; ++r) ud[r] = DualOf<double>(ub[r], NX + r == j ? 1.0 : 0.0);
      if (clamped) M::step(xd, ud, p, o);
      else M::step_unclamped(xd, ud, p, o);
      for (int i = 0; i < NX; ++i) D[(b * NX + i) * N + j] = o[i].d;
    }
  }
}
// per example: the cost at double and quad_at's (H, g), H in full
extern "C" void cost_eval(const double* cp, const double* tau, int B, double* c, double* H,
                          double* g) {
  constexpr int N = C::N;
  for (int b = 0; b < B; ++b) {
    const double* t = tau + b * N;
    c[b] = C::cost(t, cp);
    const CostQuad<N, double> q = quad_at<C, N, double>(t, cp);
    for (int i = 0; i < N; ++i) {
      g[b * N + i] = q.g[i];
      for (int j = 0; j < N; ++j) H[(b * N + i) * N + j] = q.Ce(i * N + j);
    }
  }
}
// The operations of one evaluation, as traced.py counts them: tally::F is
// a float that counts each operation it takes part in, as a tangent one
// where an operand holds a tangent (tests/test_torch_csrc.py's counter,
// with the rest of the traced set); tally::D a double for cos_sin's.
namespace tally {
struct Counts {
  long f32, f64, tangent;
};
static Counts n;
struct F {
  float v;
  bool t;
  F() = default;
  F(float x, bool tangent = false) : v(x), t(tangent) {}
};
static F op(F a, F b, float r) {
  (a.t || b.t ? n.tangent : n.f32) += 1;
  return F(r, a.t || b.t);
}
inline F operator+(F a, F b) { return op(a, b, a.v + b.v); }
inline F operator-(F a, F b) { return op(a, b, a.v - b.v); }
inline F operator*(F a, F b) { return op(a, b, a.v * b.v); }
inline F operator/(F a, F b) { return op(a, b, a.v / b.v); }
inline F operator-(F a) { return F(-a.v, a.t); }
inline bool operator<(F a, F b) { return a.v < b.v; }
inline bool operator>(F a, F b) { return a.v > b.v; }
inline bool operator<=(F a, F b) { return a.v <= b.v; }
inline bool operator>=(F a, F b) { return a.v >= b.v; }
inline bool operator==(F a, F b) { return a.v == b.v; }
inline bool operator!=(F a, F b) { return a.v != b.v; }
struct D {
  double v;
  D() = default;
  D(double x) : v(x) {}
  explicit operator float() const { return (float)v; }
};
inline D operator+(D a, D b) { ++n.f64; return a.v + b.v; }
inline D operator-(D a, D b) { ++n.f64; return a.v - b.v; }
inline D operator*(D a, D b) { ++n.f64; return a.v * b.v; }
inline D operator-(D a) { return -a.v; }
inline bool operator==(D a, D b) { return a.v == b.v; }
inline D rint(D a) { ++n.f64; return std::rint(a.v); }
inline D floor(D a) { ++n.f64; return std::floor(a.v); }
inline D fma(D a, D b, D c) { n.f64 += 2; return std::fma(a.v, b.v, c.v); }
inline F un(F a, float r) { return op(a, a, r); }
inline F sqrt_s(F a) { return un(a, std::sqrt(a.v)); }
inline F rsqrt_s(F a) { return un(a, 1.0f / std::sqrt(a.v)); }
inline F atan2_s(F y, F x) { return op(y, x, std::atan2(y.v, x.v)); }
inline F exp_s(F a) { return un(a, std::exp(a.v)); }
inline F log_s(F a) { return un(a, std::log(a.v)); }
inline F tanh_s(F a) { return un(a, std::tanh(a.v)); }
inline F abs_s(F a) { return un(a, std::fabs(a.v)); }
inline F pow_s(F a, double e) { return un(a, std::pow(a.v, (float)e)); }
inline F max_s(F a, F b) { return op(a, b, std::fmax(a.v, b.v)); }
inline F min_s(F a, F b) { return op(a, b, std::fmin(a.v, b.v)); }
inline void cos_sin_s(F x, F* c, F* s) {
  float cf, sf;
  dilqr::cos_sin<D>(x.v, &cf, &sf);
  *c = F(cf);
  *s = F(sf);
}
}  // namespace tally
// out: the float step's FP32 and FP64 operations, then the Dual step's
// FP32 value, FP64 and FP32 tangent operations, at (x, u)
extern "C" void model_ops(int clamped, const float* p, const float* x, const float* u,
                          long* out) {
  using tally::F;
  using DF = DualOf<F>;
  F xf[M::NX], uf[M::NU], xnf[M::NX];
  DF xd[M::NX], ud[M::NU], xnd[M::NX];
  for (int i = 0; i < M::NX; ++i) {
    xf[i] = F(x[i]);
    xd[i] = DF(F(x[i]), F(0.0f, true));
  }
  for (int r = 0; r < M::NU; ++r) {
    uf[r] = F(u[r]);
    ud[r] = DF(F(u[r]), F(0.0f, true));
  }
  tally::n = {};
  if (clamped) M::step(xf, uf, p, xnf);
  else M::step_unclamped(xf, uf, p, xnf);
  out[0] = tally::n.f32 + tally::n.tangent;
  out[1] = tally::n.f64;
  tally::n = {};
  if (clamped) M::step(xd, ud, p, xnd);
  else M::step_unclamped(xd, ud, p, xnd);
  out[2] = tally::n.f32;
  out[3] = tally::n.f64;
  out[4] = tally::n.tangent;
}
// out: the float cost's FP32 and FP64 operations, then one evaluation on
// DualOf<DualOf<F>>'s (all FP32, FP64), at tau
extern "C" void cost_ops(const float* cp, const float* tau, long* out) {
  using tally::F;
  using DD = DualOf<DualOf<F>>;
  F tf[C::N];
  DD td[C::N];
  for (int k = 0; k < C::N; ++k) {
    tf[k] = F(tau[k]);
    td[k] = DD(DualOf<F>(F(tau[k]), F(k == 0 ? 1.0f : 0.0f)),
               DualOf<F>(F(k == 0 ? 1.0f : 0.0f), F(0.0f)));
  }
  tally::n = {};
  C::cost(tf, cp);
  out[0] = tally::n.f32 + tally::n.tangent;
  out[1] = tally::n.f64;
  tally::n = {};
  C::cost(td, cp);
  out[2] = tally::n.f32 + tally::n.tangent;
  out[3] = tally::n.f64;
}
"""


def _env_models():
    """name -> (model, its params at f64, the cost traced beside it, the
    cost's params or None)."""
    pc = np.concatenate([0.5 + np.arange(4) / 8.0, 0.3 * np.array([0.5, -1.0, 0.2, 0.7])])
    dc = np.concatenate([np.array(tm.DP_COST), np.array([0.1, -0.2, 0.3, 0.0])])
    return {
        "cartpole": (tcart.make(), tcart.default_params(torch.float64).numpy(),
                     tm.pendulum_cost, pc),
        "pendulum": (tpend.make(), tpend.default_params(torch.float64).numpy(),
                     lambda tau, _p: tm.pendulum_cost_plain(tau), None),
        "rocket": (trock.make(), trock.default_params(torch.float64).numpy(),
                   tm.pendulum_cost, pc),
        "double pendulum": (tm.double_pendulum(), np.array(tm.DP_PARAMS), tm.dp_cost, dc),
    }


MODELS = _env_models()


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """name -> (the ctypes library of its generated header, the traced
    model, the traced cost); one g++ each, all started together."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the generated header for the host")
    procs = {}
    for name, (dyn, prm, cfn, cp) in MODELS.items():
        m = traced.model(dyn, dyn.n_state, dyn.n_ctrl, len(prm))
        c = traced.cost(cfn, 4 if cfn is not tm.dp_cost else 6, None if cp is None else len(cp))
        assert m is not None and c is not None, name
        procs[name] = (m, c) + _gxx(gxx, tmp_path_factory.mktemp(name.replace(" ", "_")),
                                    traced.header(m, c))
    return {name: (_loaded(out, proc), m, c) for name, (m, c, out, proc) in procs.items()}


def _gxx(gxx, d, header):
    """Start g++ on the shim over ``header`` in directory d: (the library's
    path, the process)."""
    (d / "dilqr_traced.cuh").write_text(header)
    (d / "shim.cpp").write_text(SHIM)
    out = d / "libshim.so"
    return out, subprocess.Popen(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, "-I", str(d), "-o",
         str(out), str(d / "shim.cpp")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _loaded(out, proc):
    log = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, log.decode()[-3000:]
    return ctypes.CDLL(str(out))


def _dp(a):
    return np.ascontiguousarray(a, np.float64).ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _point(name, B, seed):
    """Random states (the angle pairs on the circle) and controls, some of
    the double pendulum's past its +-1.5 box."""
    dyn = MODELS[name][0]
    rng = np.random.RandomState(seed)
    x = rng.randn(B, dyn.n_state)
    u = rng.randn(B, dyn.n_ctrl) * (1.2 if name == "double pendulum" else 0.5)
    if name in ("cartpole", "pendulum"):
        th, i = rng.uniform(-3, 3, B), 2 if name == "cartpole" else 0
        x[:, i], x[:, i + 1] = np.cos(th), np.sin(th)
    if name == "rocket":
        q = rng.randn(B, 4)
        x[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return x, u


@pytest.mark.parametrize("clamped", [True, False], ids=["step", "linearize_point"])
@pytest.mark.parametrize("name", list(MODELS))
def test_generated_model_matches_torch_f64(host_libs, name, clamped):
    """The generated step (or linearization point) at double equals the
    torch function at f64 within 1e-12 (of the largest entry), and its
    Jacobian on DualOf<double> equals torch.func.jvp column by column."""
    lib, m, _ = host_libs[name]
    dyn, prm = MODELS[name][:2]
    nx, nu = dyn.n_state, dyn.n_ctrl
    B = 6
    x, u = _point(name, B, 3)
    xn, D = np.zeros((B, nx)), np.zeros((B, nx, nx + nu))
    lib.model_eval(int(clamped), _dp(prm), _dp(x), _dp(u), B, _dp(xn), _dp(D))
    fn = dyn.step if clamped else dyn.linearize_point
    tx, tu, tp = (from_numpy(a) for a in (x, u, prm))
    want = fn(tx, tu, tp).numpy()
    want_D = fused.jvp_jacobian(fn)(tx, tu, tp).numpy()
    scale = max(1.0, np.abs(want).max())
    assert np.abs(xn - want).max() <= 1e-12 * scale
    assert np.abs(D - want_D).max() <= 1e-12 * max(1.0, np.abs(want_D).max())


@pytest.mark.parametrize("name", ["cartpole", "pendulum", "double pendulum"])
def test_generated_cost_quad_matches_torch_f64(host_libs, name):
    """A callable cost (with params, without, and the double pendulum's):
    its value at double, and quad_at's (H, g) by forward over forward on
    nested Duals against torch.func.hessian and grad at f64."""
    lib, _, c = host_libs[name]
    cfn, cp = MODELS[name][2:]
    n, B = c.n, 5
    tau = np.random.RandomState(4).randn(B, n)
    cpa = np.zeros(1) if cp is None else cp
    got_c, H, g = np.zeros(B), np.zeros((B, n, n)), np.zeros((B, n))
    lib.cost_eval(_dp(cpa), _dp(tau), B, _dp(got_c), _dp(H), _dp(g))
    tcp = () if cp is None else from_numpy(cp)
    f = lambda t: cfn(t, tcp)  # noqa: E731
    tt = from_numpy(tau)
    want_c = torch.func.vmap(f)(tt).numpy()
    want_g = torch.func.vmap(torch.func.grad(f))(tt).numpy()
    want_H = torch.func.vmap(torch.func.hessian(f))(tt).numpy()
    for got, want in ((got_c, want_c), (g, want_g), (H, want_H)):
        assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("name", list(MODELS))
def test_operation_counts_match_a_counting_build(host_libs, name):
    """traced.py's counts (the bound's) equal those of the generated code
    run over a counting scalar: the step and the linearization point as
    floats and on Duals (StepOps), the cost as a float and on nested Duals
    (CostOps), at a point where no clamp binds."""
    lib, m, c = host_libs[name]
    dyn, prm, _, cp = MODELS[name]
    x, u = _point(name, 1, 5)
    u = 0.1 * np.tanh(u)
    f32 = lambda a: np.ascontiguousarray(a, np.float32).ctypes.data_as(  # noqa: E731
        ctypes.POINTER(ctypes.c_float))
    for clamped, want in ((1, m.step), (0, m.lin)):
        out = (ctypes.c_long * 5)()
        lib.model_ops(clamped, f32(prm), f32(x[0]), f32(u[0]), out)
        assert tuple(out) == tuple(want), (clamped, tuple(out), want)
    out = (ctypes.c_long * 4)()
    lib.cost_ops(f32(np.zeros(1) if cp is None else cp), f32(np.linspace(-0.5, 0.5, c.n)), out)
    assert tuple(out) == tuple(c.ops[:4]), (tuple(out), c.ops)
    assert c.ops.hess_evals == c.n * (c.n + 1) // 2


# ---- the plain version against JAX's kernel in interpret mode ----

def _compare(jres, out):
    x, u, costs, _, n_iter = out
    np.testing.assert_allclose(u.transpose(0, 1).numpy(), np.asarray(jres.u), atol=2e-3)
    np.testing.assert_allclose(x.transpose(0, 1).numpy(), np.asarray(jres.x), atol=5e-3)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jres.costs), atol=1e-5, rtol=1e-5)
    assert int(n_iter) == int(jres.n_iter)


@pytest.mark.parametrize("method", ["ANALYTIC", "AUTO_DIFF"])
@pytest.mark.parametrize("boxed", [False, True])
def test_user_model_reference_matches_jax_kernel(boxed, method):
    """The double pendulum (tests/test_fused_edge_cases.py:96-110's problem)
    through the plain version, its Jacobian the jvp sweep of the step
    (AUTO_DIFF, the saturated controls' columns halved at the box as
    jnp.clip's are) or of its linearization point (ANALYTIC), against JAX's
    kernel, which JAX's gate admits."""
    jdyn, tdyn = _double_pendulum_style(), tm.double_pendulum()
    params = np.array(tm.DP_PARAMS, np.float32)
    B, T = 4, 6
    x0 = np.random.RandomState(0).uniform(-1, 1, (B, 4)).astype(np.float32)
    q, p = np.array(tm.DP_COST, np.float32), np.zeros(6, np.float32)
    kw = dict(n_state=4, n_ctrl=2, T=T, lqr_iter=4, eps=0.0,
              linesearch_decay=jdyn.linesearch_decay, max_linesearch_iter=jdyn.max_linesearch_iter,
              exit_unconverged=False, detach_unconverged=False, backprop=False)
    lo, hi = (jdyn.lower, jdyn.upper) if boxed else (None, None)
    assert lane_compatible(jdyn, jnp.asarray(params), 4, 2)
    jres = J.solve(J.ILQRConfig(backend="pallas", grad_method=getattr(J.GradMethod, method), **kw),
                   jnp.asarray(x0), J.QuadCost(jnp.diag(q), jnp.asarray(p)), jdyn,
                   params=jnp.asarray(params), u_lower=lo, u_upper=hi)
    tcfg = P.ILQRConfig(grad_method=getattr(P.GradMethod, method), **kw)
    assert fused.covered(tcfg, tdyn, from_numpy(params), torch.float32,
                         (torch.diag(from_numpy(q)), from_numpy(p)), None, None, lo, hi)
    out = fused.ilqr_fused_reference(tcfg, tdyn, from_numpy(params), from_numpy(x0),
                                     (torch.diag(from_numpy(q)), from_numpy(p)), None, lo, hi)
    _compare(jres, out)
    if boxed:
        assert (np.abs(np.asarray(jres.u)) >= 1.5 - 1e-6).any()  # the box binds


@pytest.mark.parametrize("with_params", [True, False])
def test_callable_cost_reference_matches_jax_kernel(with_params):
    """The pendulum with the callable cost of tests/test_fused_edge_cases.py:
    266-313 (its inputs from the same seed): the true cost in the
    objectives, (H, g) by forward over forward in each Riccati step."""
    rng = np.random.RandomState(7)
    B, T = 4, 6
    th = rng.uniform(-2, 2, B).astype(np.float32)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B, np.float32)], 1)
    jdyn, tdyn = jpend.make(), tpend.make()
    params = np.asarray(jpend.default_params(), np.float32)
    kw = dict(n_state=3, n_ctrl=1, T=T, lqr_iter=5, eps=0.0,
              linesearch_decay=jdyn.linesearch_decay, max_linesearch_iter=jdyn.max_linesearch_iter,
              exit_unconverged=False, detach_unconverged=False, backprop=False)
    if with_params:
        cp = np.concatenate([0.5 + rng.rand(4), 0.3 * rng.randn(4)]).astype(np.float32)
        jcost, fn, tcp = (tm.pendulum_cost, jnp.asarray(cp)), tm.pendulum_cost, from_numpy(cp)
    else:
        jcost, fn, tcp = tm.pendulum_cost_plain, lambda tau, _p: tm.pendulum_cost_plain(tau), None
    assert cost_lane_compatible(lambda tau, p: tm.pendulum_cost(tau, p), 4, 8)
    jres = J.solve(J.ILQRConfig(backend="pallas", **kw), jnp.asarray(x0), jcost, jdyn,
                   params=jnp.asarray(params), u_lower=-2.0, u_upper=2.0)
    tcfg = P.ILQRConfig(**kw)
    cc = tilqr.callable_cost(tcfg, (fn, () if tcp is None else tcp))
    assert cc is not None
    assert fused.covered(tcfg, tdyn, from_numpy(params), torch.float32, None, None, None,
                         -2.0, 2.0, cost_callable=True)
    out = fused.ilqr_fused_reference(tcfg, tdyn, from_numpy(params), from_numpy(x0), cc, None,
                                     -2.0, 2.0)
    _compare(jres, out)


# ---- the slice end to end ----

def _dp_problem(dtype):
    rng = np.random.RandomState(11)
    B, T = 3, 8
    return dict(x0=rng.uniform(-0.6, 0.6, (B, 4)).astype(dtype),
                p=np.array(tm.DP_PARAMS, dtype),
                cp=np.concatenate([tm.DP_COST, [0.1, -0.2, 0.3, 0.0]]).astype(dtype),
                wx=rng.randn(B, T, 4), wu=rng.randn(B, T, 2), T=T)


def _dp_cfg_kw(T):
    return dict(n_state=4, n_ctrl=2, T=T, lqr_iter=40, eps=1e-10, linesearch_decay=0.5,
                max_linesearch_iter=4, detach_unconverged=False, exit_unconverged=False)


def test_user_model_callable_cost_ift_grads_match_jax_f64():
    """solve and the IFT gradient of sum(u wu) + sum(x wx) with respect to
    the double pendulum's params and the callable cost's params: the port
    (on CPU tensors the plain loop) against JAX's solve and jax.grad at f64."""
    pr = _dp_problem(np.float64)
    jcfg = J.ILQRConfig(backward_mode=J.BackwardMode.IFT, backend="xla", **_dp_cfg_kw(pr["T"]))
    jdyn = _double_pendulum_style()

    def loss(p, cp):
        r = J.solve(jcfg, jnp.asarray(pr["x0"]), (tm.dp_cost, cp), jdyn, params=p,
                    u_lower=-tm.DP_BOX, u_upper=tm.DP_BOX)
        return jnp.sum(r.u * pr["wu"]) + jnp.sum(r.x * pr["wx"])

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pr["p"]), jnp.asarray(pr["cp"]))
    tp = from_numpy(pr["p"]).requires_grad_(True)
    tcp = from_numpy(pr["cp"]).requires_grad_(True)
    res = P.solve(P.ILQRConfig(backward_mode=P.BackwardMode.IFT, **_dp_cfg_kw(pr["T"])),
                  from_numpy(pr["x0"]), (tm.dp_cost, tcp), tm.double_pendulum(), params=tp,
                  u_lower=-tm.DP_BOX, u_upper=tm.DP_BOX)
    assert bool(res.converged.all())
    tl = (res.u * from_numpy(pr["wu"])).sum() + (res.x * from_numpy(pr["wx"])).sum()
    got = torch.autograd.grad(tl, (tp, tcp))
    np.testing.assert_allclose(res.costs.numpy(), np.asarray(J.solve(
        jcfg, jnp.asarray(pr["x0"]), (tm.dp_cost, jnp.asarray(pr["cp"])), jdyn,
        params=jnp.asarray(pr["p"]), u_lower=-tm.DP_BOX, u_upper=tm.DP_BOX).costs), rtol=1e-9)
    for g, w, name in zip(got, want, ("dparams", "dcost_params")):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / max(1.0, np.abs(w).max())
        assert err <= 1e-6, f"{name}: rel err {err:.2e}\n{g}\n{w}"
        assert np.abs(w).max() > 1e-3


def _card_like():
    """A stand-in for CUDA tensors at the dispatch (use_kernel reads only
    is_cuda and dtype), the trace's samples on the CPU."""
    return types.SimpleNamespace(is_cuda=True, dtype=torch.float32, device=torch.device("cpu"))


def test_trace_cache_serves_the_second_solve():
    """The dispatch of a solve on the card (callable_cost, then use_kernel's
    covered) traces the model's two functions and the cost once; a second
    solve's dispatch traces nothing. A cost of tau alone is traced as the
    user wrote it, the function solve was given."""
    dyn = tm.double_pendulum()
    cp = from_numpy(np.concatenate([tm.DP_COST, [0.0] * 4]).astype(np.float32))
    cfg = P.ILQRConfig(n_state=4, n_ctrl=2, T=5, lqr_iter=2, eps=0.0, backprop=False,
                       exit_unconverged=False)
    kp = from_numpy(np.array(tm.DP_PARAMS, np.float32))

    def cost(tau, p):  # a function of its own: no earlier test traced it
        return tm.dp_cost(tau, p)

    def dispatch():
        cc = tilqr.callable_cost(cfg, (cost, cp), torch.device("cpu"))
        return cc is not None and tilqr.use_kernel(
            cfg, lambda tau: cost(tau, cp), dyn, kp, _card_like(), None, None, None, -1.5, 1.5,
            cost_callable=cc)

    before = traced.TRACES
    assert dispatch()
    assert traced.TRACES == before + 3
    assert dispatch()
    assert traced.TRACES == before + 3

    def of_tau(tau):
        return 0.5 * (tau * tau).sum(-1)

    prob, _ = P.diff.modes._problem(cfg, of_tau, dyn, kp)
    assert prob.cost_struct(()) == (of_tau, None)
    cc = tilqr.callable_cost(cfg, prob.cost_struct(()))
    assert cc is not None and cc.trace.unary and cc.params is None
    assert traced.TRACES == before + 4
    assert tilqr.callable_cost(cfg, prob.cost_struct(())).trace is cc.trace
    assert traced.TRACES == before + 4


def test_cpu_solve_traces_nothing():
    """A solve on CPU tensors runs the plain loop and never traces: a model
    and a cost made anew for the solve, as an MPC loop makes a tracking
    cost each step (a closure over its reference), leave TRACES as it was,
    under backend "auto" and "torch" alike, with the same bits."""
    dyn = tm.double_pendulum(lambda x, u, p: tm.dp_step(x, u, p),
                             lambda x, u, p: tm.dp_step_unclamped(x, u, p))
    x0 = from_numpy(np.random.RandomState(2).uniform(-1, 1, (3, 4)).astype(np.float32))
    ref = from_numpy(np.random.RandomState(5).uniform(-0.2, 0.2, 6).astype(np.float32))
    kp = from_numpy(np.array(tm.DP_PARAMS, np.float32))
    cfg = P.ILQRConfig(n_state=4, n_ctrl=2, T=5, lqr_iter=2, eps=0.0, backprop=False,
                       exit_unconverged=False)
    before = traced.TRACES
    out = [P.solve(dataclasses.replace(cfg, backend=be), x0,
                   lambda tau: ((tau - ref) ** 2).sum(), dyn, params=kp,
                   u_lower=-1.5, u_upper=1.5) for be in ("auto", "torch")]
    assert traced.TRACES == before
    assert torch.equal(out[0].u, out[1].u) and torch.equal(out[0].costs, out[1].costs)


def test_trace_cache_lets_a_dead_model_and_cost_go():
    """The cache holds a model or cost function weakly: once the caller lets
    it go, its entry (a refusal too) goes with it, and the tensor it
    captured with it."""
    import gc
    import weakref

    n_models, n_costs = len(traced._MODELS), len(traced._COSTS)
    dyn = tm.double_pendulum(lambda x, u, p: tm.dp_step(x, u, p))
    ref = torch.zeros(6)
    cost = lambda tau: ((tau - ref) ** 2).sum()  # noqa: E731 (an array capture: refused)
    assert traced.model(dyn, 4, 2, 3) is not None
    assert traced.cost(cost, 6, None, unary=True) is None
    assert (len(traced._MODELS), len(traced._COSTS)) == (n_models + 1, n_costs + 1)
    gone = weakref.ref(ref)
    del dyn, cost, ref
    gc.collect()
    assert (len(traced._MODELS), len(traced._COSTS)) == (n_models, n_costs)
    assert gone() is None


def test_slew_wrapper_trace_is_cached_by_its_base():
    """augment_slew_rate wraps the model anew each solve; the wrappers of
    one model share one trace, which is not the model's own."""
    from dilqr_tpu_torch.models import ctrl_passthrough

    base = tm.double_pendulum(lambda x, u, p: tm.dp_step(x, u, p))
    before = traced.TRACES
    first, second = ctrl_passthrough.make(base), ctrl_passthrough.make(base)
    assert first is not second and first.wraps is base
    m = traced.model(first, 6, 2, 3)
    assert m is not None and traced.TRACES == before + 2
    assert traced.model(second, 6, 2, 3) is m and traced.TRACES == before + 2
    own = traced.model(base, 4, 2, 3)
    assert own is not None and own is not m and traced.TRACES == before + 4


def test_captured_scalar_is_read_at_each_call(tmp_path):
    """A one-element tensor a step or a cost captures is a slot after the
    params that each launch fills with the value it holds then
    (traced.launch_params); a tensor the function makes is a constant. The
    generated code, built for the host, follows an in-place change of the
    captured tensors as the torch functions do, with no new trace."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the generated header for the host")
    gain, weight = torch.tensor(1.5), torch.tensor(0.25)

    def step(x, u, p):  # torch.tensor(0.5): made in the function, a constant
        return tm.dp_step(x, u, p) * gain + torch.tensor(0.5) * x

    def cost(tau, cp):
        return tm.dp_cost(tau, cp) + weight * tau[4] * tau[4]

    dyn = tm.double_pendulum(step, step)
    m = traced.model(dyn, 4, 2, 3)
    c = traced.cost(cost, 6, 10)
    assert m is not None and c is not None
    assert len(m.captured) == 1 and m.captured[0] is gain
    assert len(c.captured) == 1 and c.captured[0] is weight
    out, proc = _gxx(gxx, tmp_path, traced.header(m, c))
    lib = _loaded(out, proc)
    n_traces = traced.TRACES
    prm = np.array(tm.DP_PARAMS)
    cp = np.concatenate([tm.DP_COST, [0.1, -0.2, 0.3, 0.0]])
    x, u = _point("double pendulum", 4, 6)
    tau = np.concatenate([x, u], 1)
    for g, w in ((1.5, 0.25), (-0.75, 2.0)):
        gain.fill_(g)
        weight.fill_(w)
        assert traced.model(dyn, 4, 2, 3) is m and traced.cost(cost, 6, 10) is c
        # the launch's vector (f32, as the card reads it), then the params
        # at f64 before the captured values it holds
        pl = traced.launch_params(torch.from_numpy(prm), m.captured, "cpu")
        cl = traced.launch_params(torch.from_numpy(cp), c.captured, "cpu")
        assert pl.dtype == torch.float32 and pl.tolist()[3:] == [g]
        assert cl.dtype == torch.float32 and cl.tolist()[10:] == [w]
        pl, cl = np.append(prm, pl[3:].double()), np.append(cp, cl[10:].double())
        xn, D = np.zeros((4, 4)), np.zeros((4, 4, 6))
        lib.model_eval(1, _dp(pl), _dp(x), _dp(u), 4, _dp(xn), _dp(D))
        want = step(*(from_numpy(a) for a in (x, u, prm))).numpy()
        np.testing.assert_allclose(xn, want, rtol=0, atol=1e-12 * max(1.0, np.abs(want).max()))
        got_c, H, gv = np.zeros(4), np.zeros((4, 6, 6)), np.zeros((4, 6))
        lib.cost_eval(_dp(cl), _dp(tau), 4, _dp(got_c), _dp(H), _dp(gv))
        want_c = torch.func.vmap(lambda t: cost(t, from_numpy(cp)))(from_numpy(tau)).numpy()
        np.testing.assert_allclose(got_c, want_c, rtol=1e-12)
    assert traced.TRACES == n_traces


def _refusals():
    """label -> (model, params, cost, dtype)."""
    p = from_numpy(np.array(tm.DP_PARAMS, np.float32))
    q = torch.diag(from_numpy(np.array(tm.DP_COST, np.float32)))
    quad = P.QuadCost(q, torch.zeros(6))
    return {
        "array capture": (tm.double_pendulum(tm.array_capture_step, tm.array_capture_step), p,
                          quad, torch.float32),
        "branch on data": (tm.double_pendulum(tm.branching_step, tm.branching_step), p, quad,
                           torch.float32),
        "op outside the set": (tm.double_pendulum(tm.det_step, tm.det_step), p, quad,
                               torch.float32),
        "f64": (tm.double_pendulum(), p, quad, torch.float64),
        "pytree params": (tm.double_pendulum(tm.dp_step_pytree, tm.dp_step_pytree),
                          {"k": p[:2], "d": p[2:]}, quad, torch.float32),
        "cost array capture": (tpend.make(), tpend.default_params(), tm.array_capture_cost,
                               torch.float32),
    }


@pytest.mark.parametrize("label", list(_refusals()))
def test_refusals_keep_the_plain_loop(label):
    """Each refusal: the gate refuses (the trace or the dtype), the solve
    gives the plain loop's bits, and backend="cuda" raises, on CPU tensors
    for the tensors and on card-like ones for the configuration."""
    dyn, params, cost, dtype = _refusals()[label]
    nx, nu = dyn.n_state, dyn.n_ctrl
    x0 = from_numpy(np.random.RandomState(3).uniform(-0.5, 0.5, (3, nx)).astype(np.float32))
    if label == "cost array capture":
        th = torch.tensor([0.3, -1.0, 2.0])
        x0 = torch.stack([th.cos(), th.sin(), torch.zeros(3)], 1)
    x0 = x0.to(dtype)
    cfg = P.ILQRConfig(n_state=nx, n_ctrl=nu, T=5, lqr_iter=2, eps=0.0, backprop=False,
                       exit_unconverged=False)
    kp = tilqr.kernel_params(dyn, params)
    cc = None
    if isinstance(cost, P.QuadCost):
        ok = fused.covered(cfg, dyn, kp, dtype, tuple(cost), None, None, -1.5, 1.5)
    else:
        cc = tilqr.callable_cost(cfg, (lambda tau, _p: cost(tau), ()))
        assert cc is None
        ok = False
    assert not ok
    lo, hi = (-2.0, 2.0) if label == "cost array capture" else (-1.5, 1.5)
    auto = P.solve(cfg, x0, cost, dyn, params=params, u_lower=lo, u_upper=hi)
    plain = P.solve(dataclasses.replace(cfg, backend="torch"), x0, cost, dyn, params=params,
                    u_lower=lo, u_upper=hi)
    assert torch.equal(auto.u, plain.u) and torch.equal(auto.costs, plain.costs)
    ccfg = dataclasses.replace(cfg, backend="cuda")
    with pytest.raises(ValueError, match="backend='cuda' needs CUDA tensors"):
        tilqr.use_kernel(ccfg, cost, dyn, kp, x0, None, None, None, lo, hi)
    card_like = types.SimpleNamespace(is_cuda=True, dtype=dtype)
    with pytest.raises(ValueError, match="not covered by the CUDA kernel"):
        tilqr.use_kernel(ccfg, cost, dyn, kp, card_like, None, None, None, lo, hi)
