"""Closed-loop receding-horizon control (counterpart of
``dilqr_tpu/control.py``): a Python loop over environment steps, each one
solve whose warm start is the previous plan shifted by one (drop the
applied action, repeat the last; reference rocket.py:1137)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .core.solver import solve
from .models.base import Dynamics
from .types import ILQRConfig, QuadCost


class EpisodeResult(NamedTuple):
    xs: torch.Tensor     # [B, n_steps+1, nx] closed-loop states
    us: torch.Tensor     # [B, n_steps, nu] applied actions
    costs: torch.Tensor  # [B, n_steps] per-step planning objective


def receding_horizon(
    cfg: ILQRConfig,
    dyn: Dynamics,
    params,
    cost: QuadCost,
    x_init: torch.Tensor,  # [B, nx]
    n_steps: int,
    u_lower=None,
    u_upper=None,
    env_step=None,         # optional true plant: (x [nx], u [nu], params) -> x' [nx]
    env_params=None,
) -> EpisodeResult:
    """Run ``n_steps`` of closed-loop MPC. ``env_step`` defaults to the
    model dynamics (perfect-model control); pass the true plant for
    model-mismatch experiments. The plant is applied per example, as the
    JAX package vmaps it: ``env_step(x [nx], u [nu], params)``, mapped over
    the batch by ``torch.func.vmap`` with ``params`` shared."""
    B = x_init.shape[0]
    plant = env_step if env_step is not None else dyn.step
    plant_params = env_params if env_params is not None else params
    x = x_init
    u_ws = torch.zeros(B, cfg.T, cfg.n_ctrl, dtype=x_init.dtype, device=x_init.device)
    prev_a = torch.zeros(B, cfg.n_ctrl, dtype=x_init.dtype, device=x_init.device)
    xs, us, costs = [], [], []
    for _ in range(n_steps):
        res = solve(cfg, x, cost, dyn, params=params, u_init=u_ws,
                    u_lower=u_lower, u_upper=u_upper, prev_ctrl=prev_a)
        a = res.u[:, 0]
        u_ws = torch.cat([res.u[:, 1:], res.u[:, -1:]], 1)
        xs.append(x)
        us.append(a)
        costs.append(res.costs)
        x = torch.func.vmap(lambda xi, ai: plant(xi, ai, plant_params))(x, a)
        prev_a = a
    xs.append(x)
    return EpisodeResult(torch.stack(xs, 1), torch.stack(us, 1), torch.stack(costs, 1))


def open_loop_rollout(step_fn, params, x_init, us):
    """Execute a fixed control plan on a plant with no feedback.
    ``step_fn(x [nx], u [nu], params) -> x'``, applied per example
    (``torch.func.vmap``, ``params`` shared); ``x_init`` [B, nx]; ``us``
    [B, K, nu]. Returns the visited states [B, K+1, nx] including the
    start."""
    step = torch.func.vmap(lambda xi, ui: step_fn(xi, ui, params))
    xs = [x_init]
    for k in range(us.shape[1]):
        xs.append(step(xs[-1], us[:, k]))
    return torch.stack(xs, 1)
