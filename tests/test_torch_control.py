"""The port's closed-loop driver (dilqr_tpu_torch/control.py) against the JAX
package's (dilqr_tpu/control.py) at f64, with a plant the controller did not
model: tests/test_control.py:57-80's scenario, the simple pendulum planning
against the damped, biased complex pendulum, and a plant written per example
in the JAX convention, ``f(x [nx], u [nu], params)``, that reads ``x[0]``,
``x[1]`` and ``x[2]``. Both drivers apply the plant per example.

Tolerance 1e-6 at f64: the same solves and plant steps, summation order
aside (tests/test_torch_solve.py holds the solve to the same bound)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dilqr_tpu as J
from dilqr_tpu.control import open_loop_rollout as j_open_loop
from dilqr_tpu.control import receding_horizon as j_rh
from dilqr_tpu.models import pendulum as jpend
import dilqr_tpu_torch as P
from dilqr_tpu_torch.control import open_loop_rollout, receding_horizon
from dilqr_tpu_torch.convert import from_numpy
from dilqr_tpu_torch.models import pendulum as tpend

PLANT_PARAMS = np.array([10.0, 1.25, 0.9, 0.4, 0.05])  # tests/test_control.py:67


def _per_example_plant(lib):
    """A damped pendulum with a torque gain, written for one example:
    x = (cos th, sin th, dth), u = (torque,), p = (g, gain, damping)."""

    def plant(x, u, p):
        c, s, w = x[0], x[1], x[2]
        w2 = w + 0.05 * (-p[0] * s + p[1] * u[0] - p[2] * w)
        th2 = lib.arctan2(s, c) + 0.05 * w2
        return lib.stack([lib.cos(th2), lib.sin(th2), w2])

    return plant


PLANTS = {
    "complex_pendulum": (jpend.make(simple=False).step, tpend.make(simple=False).step,
                         PLANT_PARAMS),
    "per_example": (_per_example_plant(jnp), _per_example_plant(torch),
                    np.array([9.0, 1.1, 0.2])),
}


@pytest.mark.parametrize("plant", list(PLANTS))
def test_receding_horizon_against_a_plant_matches_jax_f64(plant):
    """The simple pendulum model plans (T=16, lqr_iter 12, the torque box),
    the plant moves: closed-loop states, actions and planning costs equal
    JAX's over 8 steps, and the open-loop baseline (the first plan executed
    on the plant, tests/test_control.py:86-94) equals JAX's too."""
    j_plant, t_plant, pp = PLANTS[plant]
    jdyn, tdyn = jpend.make(), tpend.make()
    p = np.asarray(jpend.default_params(), np.float64)
    q, c = (np.asarray(a, np.float64) for a in jpend.get_true_obj())
    B, steps = 3, 8
    rng = np.random.RandomState(2)
    th = -1.2 + 2.4 * rng.rand(B)
    x0 = np.stack([np.cos(th), np.sin(th), np.zeros(B)], 1)
    kw = dict(n_state=3, n_ctrl=1, T=16, lqr_iter=12, eps=1e-4,
              linesearch_decay=jdyn.linesearch_decay,
              max_linesearch_iter=jdyn.max_linesearch_iter,
              exit_unconverged=False, detach_unconverged=False, backprop=False)
    want = j_rh(J.ILQRConfig(backend="xla", **kw), jdyn, jnp.asarray(p),
                J.QuadCost(jnp.diag(q), jnp.asarray(c)), jnp.asarray(x0), steps,
                u_lower=jdyn.lower, u_upper=jdyn.upper, env_step=j_plant,
                env_params=jnp.asarray(pp))
    cost = P.QuadCost(torch.diag(from_numpy(q)), from_numpy(c))
    got = receding_horizon(P.ILQRConfig(**kw), tdyn, from_numpy(p), cost, from_numpy(x0),
                           steps, u_lower=tdyn.lower, u_upper=tdyn.upper, env_step=t_plant,
                           env_params=from_numpy(pp))
    assert got.xs.shape == (B, steps + 1, 3) and got.xs.dtype == torch.float64
    for g, w in [(got.xs, want.xs), (got.us, want.us), (got.costs, want.costs)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)
    # the plant, not the model, moved the states: the model's own rollout
    # of the applied actions ends elsewhere
    model_xs = open_loop_rollout(tdyn.step, from_numpy(p), from_numpy(x0), got.us)
    assert np.abs(model_xs.numpy()[:, -1] - got.xs.numpy()[:, -1]).max() > 1e-3

    res0 = J.solve(J.ILQRConfig(backend="xla", **kw), jnp.asarray(x0),
                   J.QuadCost(jnp.diag(q), jnp.asarray(c)), jdyn, params=jnp.asarray(p),
                   u_lower=jdyn.lower, u_upper=jdyn.upper)
    plan = np.asarray(res0.u)[:, :steps]
    want_ol = j_open_loop(j_plant, jnp.asarray(pp), jnp.asarray(x0), jnp.asarray(plan))
    got_ol = open_loop_rollout(t_plant, from_numpy(pp), from_numpy(x0), from_numpy(plan))
    np.testing.assert_allclose(got_ol.numpy(), np.asarray(want_ol), atol=1e-10, rtol=0)
