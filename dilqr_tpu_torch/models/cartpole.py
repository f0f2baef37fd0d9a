"""Cartpole, 5-state (x, x_dot, cos th, sin th, th_dot), 1 control (force,
+-100): the Euler-integrated cartpole with dt=0.05 and params
(gravity, masscart, masspole, length). Counterpart of
``dilqr_tpu/models/cartpole.py``; its device code is ``Cartpole::step``
and ``Cartpole::jac`` in ``csrc/ilqr_fused.cuh``.
"""
from __future__ import annotations

import torch

from ..utils.batch import clamp_t
from ..utils.kernel_math import rotate_cs
from .base import Dynamics, unpack_params

DT = 0.05
FORCE_MAG = 100.0
N_STATE, N_CTRL = 5, 1
DEVICE_ENV = 0  # ENV_CARTPOLE in csrc/ilqr_fused.cuh

GOAL_STATE = (0.0, 0.0, 1.0, 0.0, 0.0)
GOAL_WEIGHTS = (0.1, 0.1, 1.0, 1.0, 0.1)
CTRL_PENALTY = 1e-3


def _step(state, u, params, clamp_u: bool, kernel: bool = False):
    gravity, masscart, masspole, length = unpack_params(params, state)
    total_mass = masspole + masscart
    polemass_length = masspole * length

    uu = u[..., 0]
    if clamp_u:
        uu = clamp_t(uu, -FORCE_MAG, FORCE_MAG)

    x, dx, cos_th, sin_th, dth = state.unbind(-1)

    cart_in = (uu + polemass_length * dth**2 * sin_th) / total_mass
    th_acc = (gravity * sin_th - cos_th * cart_in) / (
        length * (4.0 / 3.0 - masspole * cos_th**2 / total_mass)
    )
    xacc = cart_in - polemass_length * th_acc * cos_th / total_mass

    x = x + DT * dx
    dx = dx + DT * xacc
    # the reference advances by the PRE-update th_dot (cartpole.py:90)
    new_cos, new_sin = rotate_cs(cos_th, sin_th, DT * dth, kernel=kernel)
    dth = dth + DT * th_acc
    return torch.stack([x, dx, new_cos, new_sin, dth], -1)


def _jac_lanes(state, u, params):
    """Hand-derived Jacobian D = [dx'/dx | dx'/du] of the un-clamped step in
    its kernel form (rotate_cs renormalization included), [..., 5, 6].
    Transcribed from ``dilqr_tpu.models.cartpole._jac_lanes``; tested
    against it and against torch.func.jacfwd."""
    gravity, masscart, masspole, length = unpack_params(params, state)
    tm = masspole + masscart
    pml = masspole * length
    dt = DT

    x, v, c, s, w = state.unbind(-1)
    uu = u[..., 0]
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)

    ci = (uu + pml * (w * w) * s) / tm
    den = length * (4.0 / 3.0 - masspole * (c * c) / tm)
    ta = (gravity * s - c * ci) / den

    ci_s = pml * (w * w) / tm + zero
    ci_w = 2.0 * pml * w * s / tm
    ci_u = 1.0 / tm + zero
    den_c = -2.0 * length * masspole * c / tm
    ta_c = (-ci - ta * den_c) / den
    ta_s = (gravity - c * ci_s) / den
    ta_w = -c * ci_w / den
    ta_u = -c * ci_u / den
    k = pml / tm
    xacc_c = -k * (ta_c * c + ta)
    xacc_s = ci_s - k * ta_s * c
    xacc_w = ci_w - k * ta_w * c
    xacc_u = ci_u - k * ta_u * c

    delta = dt * w
    cd = torch.cos(delta)
    sd = torch.sin(delta)
    ct = c * cd - s * sd
    st = s * cd + c * sd
    nn = ct * ct + st * st
    r = torch.rsqrt(torch.clamp(nn, min=1e-30))
    r2 = r * r
    A_c = ct * cd + st * sd
    A_s = -ct * sd + st * cd
    o3 = ct * r
    o4 = st * r
    d_o3_c = r * (cd - ct * A_c * r2)
    d_o3_s = r * (-sd - ct * A_s * r2)
    d_o4_c = r * (sd - st * A_c * r2)
    d_o4_s = r * (cd - st * A_s * r2)

    rows = [
        [one, dt + zero, zero, zero, zero, zero],
        [zero, one, dt * xacc_c, dt * xacc_s, dt * xacc_w, dt * xacc_u],
        [zero, zero, d_o3_c, d_o3_s, -dt * o4, zero],
        [zero, zero, d_o4_c, d_o4_s, dt * o3, zero],
        [zero, zero, dt * ta_c, dt * ta_s, one + dt * ta_w, dt * ta_u],
    ]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def default_params(dtype=torch.float32, device=None) -> torch.Tensor:
    """(gravity, masscart, masspole, length) = (9.8, 1.0, 0.1, 0.5)."""
    return torch.tensor([9.8, 1.0, 0.1, 0.5], dtype=dtype, device=device)


def get_true_obj(n_ctrl: int = N_CTRL, dtype=torch.float32, device=None):
    """Diagonal cost spec (q, p) with p = -sqrt(w) * x_goal."""
    w = torch.tensor(GOAL_WEIGHTS, dtype=dtype, device=device)
    goal = torch.tensor(GOAL_STATE, dtype=dtype, device=device)
    q = torch.cat([w, CTRL_PENALTY * torch.ones(n_ctrl, dtype=dtype, device=device)])
    p = torch.cat([-torch.sqrt(w) * goal, torch.zeros(n_ctrl, dtype=dtype, device=device)])
    return q, p


def make() -> Dynamics:
    return Dynamics(
        n_state=N_STATE,
        n_ctrl=N_CTRL,
        step=lambda x, u, p: _step(x, u, p, clamp_u=True),
        step_unclamped=lambda x, u, p: _step(x, u, p, clamp_u=False),
        jac_lanes=_jac_lanes,
        kernel_step=lambda x, u, p: _step(x, u, p, clamp_u=True, kernel=True),
        device_env=DEVICE_ENV,
        lower=-FORCE_MAG,
        upper=FORCE_MAG,
        mpc_eps=1e-4,
        linesearch_decay=0.5,
        max_linesearch_iter=2,
    )
