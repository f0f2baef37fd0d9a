"""Torque-limited pendulum swing-up, 3-state (cos th, sin th, th_dot),
1 control. Counterpart of ``dilqr_tpu/models/pendulum.py``: Euler step

    th_dot' = th_dot + dt * (1.5 g/l sin th + 3 u / (m l^2))
    th'     = th + dt * th_dot'

with dt=0.05 and the torque clamped to +-2 inside the step. Params
(g, m, l) (simple) or (g, m, l, d, b) (damped/biased). Both have device
code in ``csrc/ilqr_fused.cuh``: the simple variant ``Pendulum::step`` and
its hand-derived ``Pendulum::jac``, the complex one ``PendulumComplex::step``
(atan2, then cos/sin of the new angle), whose Jacobian the kernel forms by
forward mode (``JvpJac``), as JAX's kernel does: it has no ``jac_lanes``.
"""
from __future__ import annotations

import torch

from ..utils.batch import clamp_t
from ..utils.kernel_math import rotate_cs
from .base import Dynamics, unpack_params

DT = 0.05
MAX_TORQUE = 2.0
N_STATE, N_CTRL = 3, 1
DEVICE_ENV = 1  # ENV_PENDULUM in csrc/ilqr_fused.cuh
DEVICE_ENV_COMPLEX = 6  # ENV_PENDULUM_COMPLEX

GOAL_STATE = (1.0, 0.0, 0.0)
GOAL_WEIGHTS = (1.0, 1.0, 0.1)
CTRL_PENALTY = 1e-3


def _step(x, u, params, clamp_u: bool, simple: bool, kernel: bool = False):
    p = unpack_params(params, x)
    uu = u[..., 0]
    if clamp_u:
        uu = clamp_t(uu, -MAX_TORQUE, MAX_TORQUE)
    cos_th, sin_th, dth = x.unbind(-1)
    if simple:
        g, m, l = p
        newdth = dth + DT * (-3.0 * g / (2.0 * l) * (-sin_th) + 3.0 * uu / (m * l**2))
        newcos, newsin = rotate_cs(cos_th, sin_th, newdth * DT, kernel=kernel)
        return torch.stack([newcos, newsin, newdth], -1)
    g, m, l, d, b = p
    # the damping term -d*th needs the absolute angle
    th = torch.atan2(sin_th, cos_th)
    sin_th_bias = torch.sin(th + b)
    newdth = dth + DT * (
        -3.0 * g / (2.0 * l) * (-sin_th_bias) + 3.0 * uu / (m * l**2) - d * th
    )
    newth = th + newdth * DT
    return torch.stack([torch.cos(newth), torch.sin(newth), newdth], -1)


def _jac_lanes_simple(state, u, params):
    """Hand-derived Jacobian D = [dx'/dx | dx'/du] of the un-clamped simple
    step in its kernel form, [..., 3, 4]. Transcribed from
    ``dilqr_tpu.models.pendulum._jac_lanes_simple``."""
    g, m, l = unpack_params(params, state)
    dt = DT
    c, s, w = state.unbind(-1)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)

    k_s = dt * 1.5 * g / l + zero
    k_u = dt * 3.0 / (m * l**2) + zero
    newdth = w + dt * (-3.0 * g / (2.0 * l) * (-s) + 3.0 * u[..., 0] / (m * l**2))

    delta = newdth * dt
    d_s, d_w, d_u = dt * k_s, dt * one, dt * k_u
    cd = torch.cos(delta)
    sd = torch.sin(delta)
    ct = c * cd - s * sd
    st = s * cd + c * sd
    nn = ct * ct + st * st
    r = torch.rsqrt(torch.clamp(nn, min=1e-30))
    r2 = r * r
    ct_c, st_c = cd, sd
    ct_s, st_s = -sd - st * d_s, cd + ct * d_s
    ct_w, st_w = -st * d_w, ct * d_w
    ct_u, st_u = -st * d_u, ct * d_u
    A_c = ct * ct_c + st * st_c
    A_s = ct * ct_s + st * st_s
    A_w = ct * ct_w + st * st_w
    A_u = ct * ct_u + st * st_u

    def o(cty, Ay, v):
        return r * (cty - v * Ay * r2)

    rows = [
        [o(ct_c, A_c, ct), o(ct_s, A_s, ct), o(ct_w, A_w, ct), o(ct_u, A_u, ct)],
        [o(st_c, A_c, st), o(st_s, A_s, st), o(st_w, A_w, st), o(st_u, A_u, st)],
        [zero, k_s, one, k_u],
    ]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def default_params(simple: bool = True, dtype=torch.float32, device=None) -> torch.Tensor:
    """(g, m, l) = (10, 1, 1); the complex variant adds damping d and
    gravity bias b."""
    vals = [10.0, 1.0, 1.0] if simple else [10.0, 1.0, 1.0, 0.0, 0.0]
    return torch.tensor(vals, dtype=dtype, device=device)


def get_true_obj(n_ctrl: int = N_CTRL, dtype=torch.float32, device=None):
    """Diagonal cost spec (q, p) with p = -sqrt(w) * x_goal."""
    w = torch.tensor(GOAL_WEIGHTS, dtype=dtype, device=device)
    goal = torch.tensor(GOAL_STATE, dtype=dtype, device=device)
    q = torch.cat([w, CTRL_PENALTY * torch.ones(n_ctrl, dtype=dtype, device=device)])
    p = torch.cat([-torch.sqrt(w) * goal, torch.zeros(n_ctrl, dtype=dtype, device=device)])
    return q, p


def make(simple: bool = True) -> Dynamics:
    return Dynamics(
        n_state=N_STATE,
        n_ctrl=N_CTRL,
        step=lambda x, u, p: _step(x, u, p, clamp_u=True, simple=simple),
        step_unclamped=lambda x, u, p: _step(x, u, p, clamp_u=False, simple=simple),
        jac_lanes=_jac_lanes_simple if simple else None,
        # the complex step has no separate kernel form: its angle is
        # recovered with atan2 on and off the kernel
        kernel_step=lambda x, u, p: _step(x, u, p, clamp_u=True, simple=simple, kernel=True),
        device_env=DEVICE_ENV if simple else DEVICE_ENV_COMPLEX,
        lower=-MAX_TORQUE,
        upper=MAX_TORQUE,
        mpc_eps=1e-3,
        linesearch_decay=0.2,
        max_linesearch_iter=5,
    )
