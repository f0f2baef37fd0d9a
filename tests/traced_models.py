"""User models and callable costs written in PyTorch for the traced path of
the whole-solve kernel (dilqr_tpu_torch/ops/cuda/traced.py): the nu=2
double-pendulum model and the callable pendulum costs of
tests/test_fused_edge_cases.py:68-92 and :266-313, and one model or cost
for each way to break the tracing contract. Imports no JAX, so the card
tests take them too."""
import torch

from dilqr_tpu_torch.models.base import Dynamics

DP_PARAMS = (2.0, 1.5, 0.1)  # (k1, k2, d) of the double pendulum
DP_BOX = 1.5
DP_COST = (1.0, 1.0, 0.1, 0.1, 1e-3, 1e-3)  # diagonal of its QuadCost


def _clip(v, lo, hi):
    """jnp.clip as JAX evaluates it, min(max(v, lo), hi): the derivative of
    a tie is the mean of both sides', as in JAX."""
    return torch.minimum(torch.maximum(v, torch.tensor(lo)), torch.tensor(hi))


def _dp(x, u0, u1, params):
    k1, k2, d = params.unbind(-1)
    q0, q1, v0, v1 = x.unbind(-1)
    a0 = -k1 * torch.sin(q0) - d * v0 + u0 + 0.3 * u1
    a1 = -k2 * torch.sin(q1) - d * v1 + u1 - 0.2 * u0
    dt = 0.05
    return torch.stack([q0 + dt * v0, q1 + dt * v1, v0 + dt * a0, v1 + dt * a1], -1)


def dp_step(x, u, params):
    return _dp(x, _clip(u[..., 0], -DP_BOX, DP_BOX), _clip(u[..., 1], -DP_BOX, DP_BOX), params)


def dp_step_unclamped(x, u, params):
    return _dp(x, u[..., 0], u[..., 1], params)


def double_pendulum(step=dp_step, step_unclamped=dp_step_unclamped) -> Dynamics:
    """The 4-state, 2-control synthetic env (a user's own model: no device
    code), params DP_PARAMS."""
    return Dynamics(n_state=4, n_ctrl=2, step=step, step_unclamped=step_unclamped,
                    lower=-DP_BOX, upper=DP_BOX, linesearch_decay=0.5, max_linesearch_iter=4)


def pendulum_cost(tau, p):
    """The callable cost with params: p[:4] weights, p[4:] targets."""
    acc = None
    for i in range(4):
        d = tau[i] - p[4 + i]
        term = 0.5 * p[i] * d * d
        acc = term if acc is None else acc + term
    return acc + 0.01 * tau[3] ** 4


def pendulum_cost_plain(tau):
    """The parameterless callable cost (python-float constants only)."""
    return (0.5 * (tau[0] - 1.0) ** 2 + 0.5 * tau[1] ** 2 + 0.05 * tau[2] ** 2
            + 1e-3 * tau[3] ** 2 + 0.01 * tau[3] ** 4)


def dp_cost(tau, p):
    """A callable cost over the double pendulum's tau (n = 6): p[:6] the
    diagonal weights, p[6:10] the state targets, plus a quartic term."""
    acc = 0.5 * p[4] * tau[4] * tau[4] + 0.5 * p[5] * tau[5] * tau[5]
    for i in range(4):
        d = tau[i] - p[6 + i]
        acc = acc + 0.5 * p[i] * d * d
    return acc + 0.05 * tau[0] ** 4


# ---- one way each to break the contract (refused by both packages) ----

_A = torch.tensor([[0.9, 0.1, 0.0, 0.0], [0.0, 0.9, 0.1, 0.0],
                   [0.0, 0.0, 0.9, 0.1], [0.1, 0.0, 0.0, 0.9]])


def array_capture_step(x, u, params):
    """Captures a [4, 4] matrix (A @ x)."""
    return x @ _A.to(x).T + 0.05 * torch.cat([u, u], -1)


def branching_step(x, u, params):
    """Branches on the data."""
    if float(x[..., 0].mean()) > 10.0:
        return torch.zeros_like(x)
    return dp_step(x, u, params)


def det_step(x, u, params):
    """torch.linalg.det, outside the traced set."""
    m = torch.stack([torch.stack([x[..., 0], x[..., 1]], -1),
                     torch.stack([x[..., 2], x[..., 3]], -1)], -2)
    return dp_step(x, u, params) + 1e-3 * torch.linalg.det(m)[..., None]


def dp_step_pytree(x, u, params):
    """Params as a dict {"k": [k1, k2], "d": [d]}."""
    return dp_step(x, u, torch.cat([params["k"], params["d"]]))


_W = torch.tensor([1.0, 1.0, 0.1, 1e-3])


def array_capture_cost(tau):
    """Captures a [4] weight vector (test_fused_callable_cost_array_capture_falls_back)."""
    return 0.5 * (_W.to(tau) * tau * tau).sum(0)
