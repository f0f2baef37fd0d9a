"""The kernel's per-example device code, built for the host.

csrc/ilqr_fused.cuh holds the env steps, Jacobians and the objective as
__host__ __device__ functions; g++ compiles them here (no nvcc needed) into
a small ctypes library, and each is held against the port's Python kernel
forms (Dynamics.kernel_step, Dynamics.jac_lanes) on the same f32 inputs.
Tolerance 2e-6 absolute on values of order one: the host build takes
1/sqrtf for rsqrtf and may contract to FMAs, a few ulp apart from PyTorch's
evaluation order."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dilqr_tpu_torch.models import cartpole, pendulum

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "dilqr_tpu_torch", "csrc")

SHIM = r"""
#include "ilqr_fused.cuh"
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
                    "-o", str(out), str(src)], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    P = ctypes.c_void_p
    lib.env_eval.argtypes = [ctypes.c_int, P, P, P, ctypes.c_int, P, P]
    lib.env_eval.restype = None
    lib.objective6.argtypes = [P, P, P]
    lib.objective6.restype = ctypes.c_float
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
