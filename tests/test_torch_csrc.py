"""The kernels' per-example device code, built for the host.

csrc/ilqr_fused.cuh holds the env steps, Jacobians and the objective, and
csrc/kkt_fused.cuh the whole per-example KKT VJP, as __host__ __device__
functions; g++ compiles them here (no nvcc needed) into a small ctypes
library. The env code is held against the port's Python kernel forms
(Dynamics.kernel_step, Dynamics.jac_lanes) on the same f32 inputs, the KKT
code against kkt_fused_reference. Tolerance 2e-6 absolute on values of
order one for the env code: the host build takes 1/sqrtf for rsqrtf and may
contract to FMAs, a few ulp apart from PyTorch's evaluation order; 1e-5
relative to the largest output for the KKT VJP, whose T-step recursions
carry that rounding along."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dilqr_tpu_torch.models import cartpole, pendulum
from dilqr_tpu_torch.ops.cuda import kkt_fused

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dilqr_tpu_torch", "csrc")

SHIM = r"""
#include "ilqr_fused.cuh"
#include "kkt_fused.cuh"
using namespace dilqr;
template <class Env>
static void run(const float* p, const float* x, const float* u, int B,
                float* xn, float* D) {
  Env env;
  env.load(p);
  for (int b = 0; b < B; ++b) {
    env.step(x + b * Env::NX, u[b], xn + b * Env::NX);
    float J[Env::NX][Env::NX + 1];
    env.jac(x + b * Env::NX, u[b], J);
    for (int i = 0; i < Env::NX; ++i)
      for (int j = 0; j <= Env::NX; ++j) D[(b * Env::NX + i) * (Env::NX + 1) + j] = J[i][j];
  }
}
extern "C" void env_eval(int env, const float* p, const float* x, const float* u, int B,
                         float* xn, float* D) {
  if (env == ENV_CARTPOLE) run<Cartpole>(p, x, u, B, xn, D);
  else run<Pendulum>(p, x, u, B, xn, D);
}
extern "C" float objective6(const float* tau, const float* C, const float* c) {
  return objective<6>(tau, C, c);
}
extern "C" int kkt_host(int nx, int nu, int T, int B, const float* C, const float* F,
                        const float* r, const float* uz, const float* lb, float* dtau,
                        float* lam, float* dlam, float* K, float* k) {
  const KktArgs a{T, B, C, F, r, uz, lb, dtau, lam, dlam, K, k};
#define CASE(X_, U_) \
  if (nx == X_ && nu == U_) { for (int b = 0; b < B; ++b) kkt_example<X_, U_>(a, b); return 0; }
  DILQR_KKT_SHAPES(CASE)
  return 1;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the device header for the host")
    d = tmp_path_factory.mktemp("csrc")
    src, out = d / "shim.cpp", d / "libshim.so"
    src.write_text(SHIM)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(out), str(src)], check=True, capture_output=True, timeout=180)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.env_eval.argtypes = [I, P, P, P, I, P, P]
    lib.env_eval.restype = None
    lib.objective6.argtypes = [P, P, P]
    lib.objective6.restype = ctypes.c_float
    lib.kkt_host.argtypes = [I, I, I, I] + [P] * 10
    lib.kkt_host.restype = I
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


@pytest.mark.parametrize("mod", [cartpole, pendulum], ids=["cartpole", "pendulum"])
def test_device_env_code_matches_kernel_forms(lib, mod):
    dyn = mod.make()
    nx = dyn.n_state
    rng = np.random.RandomState(0)
    B = 64
    th = rng.uniform(-np.pi, np.pi, B)
    scale = 1.0 + 0.3 * rng.randn(B)
    cs = np.stack([np.cos(th) * scale, np.sin(th) * scale], 1)
    x = (np.concatenate([rng.randn(B, 2), cs, rng.randn(B, 1)], 1) if nx == 5
         else np.concatenate([cs, rng.randn(B, 1)], 1)).astype(np.float32)
    bound = dyn.upper
    u = (1.5 * bound * rng.uniform(-1, 1, (B, 1))).astype(np.float32)  # inside and past the box
    # example 0 has the degenerate angle (0, 0): rotate_cs's zero-norm guard
    x[0, slice(2, 4) if nx == 5 else slice(0, 2)] = 0.0
    params = mod.default_params().numpy()
    xn = np.zeros((B, nx), np.float32)
    D = np.zeros((B, nx, nx + 1), np.float32)
    lib.env_eval(dyn.device_env, _ptr(params), _ptr(x), _ptr(u), B, _ptr(xn), _ptr(D))

    tx, tu, tp = torch.from_numpy(x), torch.from_numpy(u), torch.from_numpy(params)
    np.testing.assert_allclose(xn, dyn.kernel_step(tx, tu, tp).numpy(), atol=2e-6, rtol=0)
    # the Jacobian at the degenerate point is 1/sqrt(1e-30)-sized: compare
    # the others
    np.testing.assert_allclose(D[1:], dyn.jac_lanes(tx, tu, tp).numpy()[1:], atol=2e-6,
                               rtol=2e-6)


def test_device_objective_matches_torch(lib):
    rng = np.random.RandomState(1)
    A = rng.randn(6, 6)
    C = (A @ A.T).astype(np.float32)
    c = rng.randn(6).astype(np.float32)
    tau = rng.randn(6).astype(np.float32)
    C_flat = np.ascontiguousarray(C.reshape(-1))
    got = lib.objective6(_ptr(tau), _ptr(C_flat), _ptr(c))
    t = torch.from_numpy(tau)
    want = 0.5 * t @ torch.from_numpy(C) @ t + torch.from_numpy(c) @ t
    assert abs(got - float(want)) <= 2e-6 * max(1.0, abs(float(want)))


@pytest.mark.parametrize("nx,nu", kkt_fused.SHAPES)
def test_device_kkt_code_matches_plain_version(lib, nx, nu):
    """kkt_example, the code the CUDA kernel runs per example, against
    kkt_fused_reference on the same operands: every instantiated shape,
    half the controls frozen at random."""
    T, B, n = 7, 6, nx + nu
    rng = np.random.RandomState(nx * 10 + nu)
    A = rng.randn(T, B, n, n)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    C = f32(A @ A.transpose(0, 1, 3, 2) + 2.0 * np.eye(n))
    ops = kkt_fused.prepare(nx, nu, C, f32(rng.randn(T, B, n)),
                            f32(0.3 * rng.randn(T - 1, B, nx, n)), f32(rng.randn(T, B, nx)),
                            f32(rng.randn(T, B, nu)),
                            torch.from_numpy(rng.rand(T, B, nu) < 0.5))
    r = f32(rng.randn(T, n, B))
    want = kkt_fused.kkt_fused_reference(ops, r)
    outs = [np.zeros((T, k, B), np.float32) for k in (n, nx, nx, nu * nx, nu)]
    ins = [np.ascontiguousarray(a.numpy()) for a in (ops.C, ops.F, r, ops.uz, ops.lb)]
    rc = lib.kkt_host(nx, nu, T, B, *[_ptr(a) for a in ins + outs])
    assert rc == 0
    for name, got, w in zip(("dtau", "lam", "dlam"), outs[:3], want):
        w = w.numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
