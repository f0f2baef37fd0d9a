"""Env models of the PyTorch port (dilqr_tpu_torch.models) against the JAX
package: the step in both forms (sequential atan2 and kernel rotate_cs) and
the hand-derived Jacobian, at f64, plus the reference's env goldens.

Inputs are made with numpy from a seed and reach both packages as numpy
arrays (the port's through convert.from_numpy). Tolerance 1e-12 at f64:
the two packages evaluate the same expressions, so only last-bit rounding
differs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from dilqr_tpu.models import cartpole as jcart
from dilqr_tpu.models import pendulum as jpend
from dilqr_tpu.utils.kernel_math import kernel_context
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.models import cartpole as tcart
from dilqr_tpu_torch.models import pendulum as tpend

ENVS = {
    "cartpole": (jcart, tcart, {}),
    "pendulum": (jpend, tpend, {}),
    "pendulum_complex": (jpend, tpend, {"simple": False}),
}


def _points(name, B, seed):
    """States with UN-normalized (cos, sin) pairs, so the rotate_cs
    renormalization is exercised, and controls inside and past the box."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    scale = 1.0 + 0.3 * rng.randn(B)
    cs = np.stack([np.cos(th) * scale, np.sin(th) * scale], 1)
    if name == "cartpole":
        x = np.concatenate([rng.randn(B, 2), cs, rng.randn(B, 1)], 1)
        u = 80.0 * rng.randn(B, 1)
    else:
        x = np.concatenate([cs, rng.randn(B, 1)], 1)
        u = 2.5 * rng.randn(B, 1)
    return x, u


def _params(name):
    jm, _, kw = ENVS[name]
    p = np.asarray(jm.default_params(**kw), np.float64)
    if name == "pendulum_complex":
        p[3], p[4] = 0.1, 0.2  # damping + gravity bias
    return p


# the complex pendulum has no kernel form: it has no device code
STEP_CASES = [(n, f) for n in ENVS for f in ("sequential", "kernel", "unclamped")
              if not (n == "pendulum_complex" and f == "kernel")]


@pytest.mark.parametrize("name,form", STEP_CASES)
def test_step_matches_jax_f64(name, form):
    jm, tm, kw = ENVS[name]
    x, u = _points(name, 32, 0)
    p = _params(name)
    jdyn, tdyn = jm.make(**kw), tm.make(**kw)
    jfn = jdyn.step_unclamped if form == "unclamped" else jdyn.step
    tfn = {"sequential": tdyn.step, "kernel": tdyn.kernel_step,
           "unclamped": tdyn.step_unclamped}[form]
    if form == "kernel":
        with kernel_context():
            want = np.stack([np.asarray(jfn(jnp.asarray(xi), jnp.asarray(ui), jnp.asarray(p)))
                             for xi, ui in zip(x, u)])
    else:
        want = np.asarray(jax.vmap(lambda xi, ui: jfn(xi, ui, jnp.asarray(p)))(
            jnp.asarray(x), jnp.asarray(u)))
    got = tfn(from_numpy(x), from_numpy(u), from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_jac_lanes_matches_jax_and_jacfwd_f64(name):
    """jac_lanes (the kernel's Jacobian of the un-clamped step) against the
    JAX package's and against torch.func.jacfwd of the port's own
    step_unclamped."""
    jm, tm, kw = ENVS[name]
    x, u = _points(name, 32, 1)
    p = _params(name)
    jdyn, tdyn = jm.make(**kw), tm.make(**kw)
    want = np.asarray(jdyn.jac_lanes(jnp.asarray(x.T), jnp.asarray(u.T), jnp.asarray(p)))
    want = np.moveaxis(want, -1, 0)  # lanes [nx, n, B] -> [B, nx, n]
    tx, tu, tp = from_numpy(x), from_numpy(u), from_numpy(p)
    got = tdyn.jac_lanes(tx, tu, tp)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    nx = x.shape[1]
    for i in range(4):
        J = jacfwd(lambda xu: tdyn.step_unclamped(xu[:nx], xu[nx:], tp))(
            torch.cat([tx[i], tu[i]]))
        np.testing.assert_allclose(J.numpy(), got[i].numpy(), atol=1e-12, rtol=0)


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_env_golden(golden, name):
    """The reference's env goldens (step and hand-written D), at the JAX
    test's f32 tolerances (tests/test_envs.py)."""
    g = golden(f"env_{name}")
    jm, tm, _ = ENVS[name]
    dyn = tm.make()
    p = from_numpy(np.asarray(jm.default_params()))
    x = from_numpy(g["x"], dtype=torch.float32)
    u = from_numpy(g["u"], dtype=torch.float32)
    np.testing.assert_allclose(dyn.step(x, u, p).numpy(), g["x_next"], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dyn.jac_lanes(x, u, p).numpy(), g["D"], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_true_obj_matches_jax(name):
    jm, tm, _ = ENVS[name]
    for a, b in zip(jm.get_true_obj(), tm.get_true_obj()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
