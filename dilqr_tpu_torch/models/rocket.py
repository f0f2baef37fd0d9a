"""Rocket soft-landing, 13-state quaternion rigid body (r[3], v[3], q[4],
w[3]), 3 controls (thrust vector, box +-20), Euler step with dt=0.1 and
params (Jx, Jy, Jz, mass, l). Counterpart of ``dilqr_tpu/models/rocket.py``:

 * direction-cosine matrix from the quaternion, gravity (-10, 0, 0);
 * quaternion kinematics dq = 0.5 Omega(w) q;
 * torque r_T_B x T_B with r_T_B = (-l/2, 0, 0), Euler rotational dynamics
   dw = J^-1 (torque - w x J w);
 * the thrust clamped to +-400 inside the step (the +-20 box keeps it
   inactive in practice).

``normalize_quat=False`` (the default) returns the un-normalized state, as
the reference does; its step is a polynomial map with the hand-derived
Jacobian ``jac_lanes`` and device code (``Rocket::step`` / ``Rocket::jac`` in
``csrc/ilqr_fused.cuh``). ``normalize_quat=True`` renormalizes the
quaternion inside the step (``RocketNorm::step``); it has no ``jac_lanes``,
and the kernel forms its Jacobian by forward mode (``JvpJac``), as JAX's
kernel does.
"""
from __future__ import annotations

import torch

from ..utils.batch import clamp_t
from .base import Dynamics, unpack_params

DT = 0.1
N_STATE, N_CTRL = 13, 3
MAX_THRUST = 20.0 ** 2
DEVICE_ENV = 2  # ENV_ROCKET in csrc/ilqr_fused.cuh
DEVICE_ENV_NORM = 7  # ENV_ROCKET_NORM

GOAL_WEIGHTS = (10.0,) * 3 + (1.0,) * 3 + (0.1,) * 4 + (1.0,) * 3
GOAL_STATE = (0.0,) * 6 + (1.0, 0.0, 0.0, 0.0) + (0.0,) * 3
CTRL_PENALTY = (1.0, 1.0, 0.4)  # side, side, thrust
TILT_PENALTY = 50.0
# tilt_Q is pre-multiplied by tilt_penalty at init and again in the cost
# (the reference's double multiplication, rocket.py:74-78 then 225)
TILT_Q = tuple(TILT_PENALTY * v for v in (0.0, 0.0, 4.0, 4.0))
TILT_P = (0.0, 0.0, 0.0, 0.0)

LOWER = (-20.0, -20.0, -20.0)
UPPER = (20.0, 20.0, 20.0)


def _dcm_body_to_inertial_rows(q0, q1, q2, q3):
    """Rows of C_I_B = C_B_I^T, entrywise."""
    c = [
        [1 - 2 * (q2 * q2 + q3 * q3), 2 * (q1 * q2 + q0 * q3), 2 * (q1 * q3 - q0 * q2)],
        [2 * (q1 * q2 - q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3), 2 * (q2 * q3 + q0 * q1)],
        [2 * (q1 * q3 + q0 * q2), 2 * (q2 * q3 - q0 * q1), 1 - 2 * (q1 * q1 + q2 * q2)],
    ]
    return [[c[j][i] for j in range(3)] for i in range(3)]


def _step(x, u, params, clamp_u: bool, normalize_quat: bool):
    Jx, Jy, Jz, mass, l = unpack_params(params, x)
    v0, v1, v2 = x[..., 3], x[..., 4], x[..., 5]
    q0, q1, q2, q3 = x[..., 6], x[..., 7], x[..., 8], x[..., 9]
    w0, w1, w2 = x[..., 10], x[..., 11], x[..., 12]
    if clamp_u:
        T_B = [clamp_t(u[..., i], -MAX_THRUST, MAX_THRUST) for i in range(3)]
    else:
        T_B = [u[..., 0], u[..., 1], u[..., 2]]

    C = _dcm_body_to_inertial_rows(q0, q1, q2, q3)
    g = (-10.0, 0.0, 0.0)
    dv = [(C[i][0] * T_B[0] + C[i][1] * T_B[1] + C[i][2] * T_B[2]) / mass + g[i]
          for i in range(3)]
    dq0 = 0.5 * (-w0 * q1 - w1 * q2 - w2 * q3)
    dq1 = 0.5 * (w0 * q0 + w2 * q2 - w1 * q3)
    dq2 = 0.5 * (w1 * q0 - w2 * q1 + w0 * q3)
    dq3 = 0.5 * (w2 * q0 + w1 * q1 - w0 * q2)
    a = -0.5 * l
    tq1 = -a * T_B[2]
    tq2 = a * T_B[1]
    cw0 = w1 * (Jz * w2) - w2 * (Jy * w1)
    cw1 = w2 * (Jx * w0) - w0 * (Jz * w2)
    cw2 = w0 * (Jy * w1) - w1 * (Jx * w0)
    dw0 = (0.0 - cw0) / Jx
    dw1 = (tq1 - cw1) / Jy
    dw2 = (tq2 - cw2) / Jz

    dx = torch.stack([v0, v1, v2, dv[0], dv[1], dv[2], dq0, dq1, dq2, dq3, dw0, dw1, dw2], -1)
    new_x = x + dx * DT
    if normalize_quat:
        nq = new_x[..., 6:10]
        nrm = torch.sqrt((nq * nq).sum(-1, keepdim=True)) + 1e-8
        new_x = torch.cat([new_x[..., :6], nq / nrm, new_x[..., 10:]], -1)
    return new_x


def _jac_lanes(x, u, params):
    """Hand-derived Jacobian D = [dx'/dx | dx'/du] of the un-clamped,
    un-normalized step, [..., 13, 16]: D = I + dt d(dx)/d(x, u), with the
    DCM partials linear in q, the quaternion block 0.5 Omega(w) and the
    Euler cross-coupling terms. Transcribed from
    ``dilqr_tpu.models.rocket._jac_lanes``; tested against it and against
    torch.func.jacfwd."""
    Jx, Jy, Jz, mass, l = unpack_params(params, x)
    dt = DT
    q0, q1, q2, q3 = x[..., 6], x[..., 7], x[..., 8], x[..., 9]
    w0, w1, w2 = x[..., 10], x[..., 11], x[..., 12]
    T = [u[..., 0], u[..., 1], u[..., 2]]
    zero = torch.zeros_like(q0)
    one = torch.ones_like(q0)

    c = [
        [1 - 2 * (q2 * q2 + q3 * q3), 2 * (q1 * q2 + q0 * q3), 2 * (q1 * q3 - q0 * q2)],
        [2 * (q1 * q2 - q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3), 2 * (q2 * q3 + q0 * q1)],
        [2 * (q1 * q3 + q0 * q2), 2 * (q2 * q3 - q0 * q1), 1 - 2 * (q1 * q1 + q2 * q2)],
    ]
    two = 2.0
    # partials of each c entry with respect to (q0, q1, q2, q3)
    dc = {
        (0, 0): [zero, zero, -2 * two * q2, -2 * two * q3],
        (0, 1): [two * q3, two * q2, two * q1, two * q0],
        (0, 2): [-two * q2, two * q3, -two * q0, two * q1],
        (1, 0): [-two * q3, two * q2, two * q1, -two * q0],
        (1, 1): [zero, -2 * two * q1, zero, -2 * two * q3],
        (1, 2): [two * q1, two * q0, two * q3, two * q2],
        (2, 0): [two * q2, two * q3, two * q0, two * q1],
        (2, 1): [-two * q1, -two * q0, two * q3, two * q2],
        (2, 2): [zero, -2 * two * q1, -2 * two * q2, zero],
    }

    rows = [[zero] * 16 for _ in range(13)]
    for i in range(3):  # r' = r + dt v
        rows[i][i] = one
        rows[i][3 + i] = dt + zero
    for m in range(3):  # v' = v + dt (R T / mass + g)
        i = 3 + m
        rows[i][i] = one
        for k in range(4):
            rows[i][6 + k] = dt * (dc[(0, m)][k] * T[0] + dc[(1, m)][k] * T[1]
                                   + dc[(2, m)][k] * T[2]) / mass
        for j in range(3):
            rows[i][13 + j] = dt * c[j][m] / mass
    h = 0.5 * dt  # q' = q + 0.5 dt Omega(w) q
    qjac = [
        ([zero, -h * w0, -h * w1, -h * w2], [-h * q1, -h * q2, -h * q3]),
        ([h * w0, zero, h * w2, -h * w1], [h * q0, -h * q3, h * q2]),
        ([h * w1, -h * w2, zero, h * w0], [h * q3, h * q0, -h * q1]),
        ([h * w2, h * w1, -h * w0, zero], [-h * q2, h * q1, h * q0]),
    ]
    for a in range(4):
        i = 6 + a
        dqq, dqw = qjac[a]
        for b in range(4):
            rows[i][6 + b] = dqq[b] + (one if a == b else zero)
        for b in range(3):
            rows[i][10 + b] = dqw[b]
    kzy, kxz, kyx = Jz - Jy, Jx - Jz, Jy - Jx  # w' = w + dt (torque - w x J w) / J
    rows[10][10] = one
    rows[10][11] = -dt * kzy * w2 / Jx
    rows[10][12] = -dt * kzy * w1 / Jx
    rows[11][10] = -dt * kxz * w2 / Jy
    rows[11][11] = one
    rows[11][12] = -dt * kxz * w0 / Jy
    rows[11][15] = dt * (0.5 * l) / Jy + zero
    rows[12][10] = -dt * kyx * w1 / Jz
    rows[12][11] = -dt * kyx * w0 / Jz
    rows[12][12] = one
    rows[12][14] = -dt * (0.5 * l) / Jz + zero
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def default_params(dtype=torch.float32, device=None) -> torch.Tensor:
    """(Jx, Jy, Jz, mass, l) = (0.5, 1, 1, 1, 1)."""
    return torch.tensor([0.5, 1.0, 1.0, 1.0, 1.0], dtype=dtype, device=device)


def get_true_obj(dtype=torch.float32, device=None):
    """Diagonal cost (q, p) with the tilt surrogate folded into the
    quaternion weights: 50 * 50 * (0, 0, 4, 4) = (0, 0, 1e4, 1e4), the
    reference's double tilt_penalty multiplication."""
    w = torch.tensor(GOAL_WEIGHTS, dtype=dtype, device=device)
    goal = torch.tensor(GOAL_STATE, dtype=dtype, device=device)
    q = torch.cat([w, torch.tensor(CTRL_PENALTY, dtype=dtype, device=device)])
    q[6:10] = torch.tensor(TILT_Q, dtype=dtype, device=device) * TILT_PENALTY
    px = -torch.sqrt(w) * goal
    px[6:10] = -torch.tensor(TILT_P, dtype=dtype, device=device) * TILT_PENALTY
    p = torch.cat([px, torch.zeros(N_CTRL, dtype=dtype, device=device)])
    return q, p


def bench_start(B: int, generator=None, dtype=torch.float32, device=None) -> torch.Tensor:
    """bench.py's rocket start (bench.py:320-325), [B, 13]: near hover 2 m
    up, height +-0.2, velocity +-0.05, quaternion identity +-0.005, rates
    +-0.01 (standard deviations), drawn on the CPU from ``generator``."""
    def n(k, s):
        return s * torch.randn(B, k, generator=generator, dtype=dtype)

    return torch.cat([torch.tensor([2.0, 0.0, 0.0], dtype=dtype) + n(3, 0.2), n(3, 0.05),
                      torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype) + n(4, 0.005),
                      n(3, 0.01)], 1).to(device)


def get_cost_matrices(n_batch: int, mpc_T: int, dtype=torch.float32, device=None):
    """Batched diagonal cost (C [B, T, 16, 16], c [B, T, 16]), diag(q) and p
    broadcast."""
    q, p = get_true_obj(dtype=dtype, device=device)
    C = torch.diag(q).expand(n_batch, mpc_T, N_STATE + N_CTRL, N_STATE + N_CTRL)
    return C, p.expand(n_batch, mpc_T, N_STATE + N_CTRL)


def make(normalize_quat: bool = False) -> Dynamics:
    step = lambda x, u, p: _step(x, u, p, True, normalize_quat)  # noqa: E731
    return Dynamics(
        n_state=N_STATE,
        n_ctrl=N_CTRL,
        step=step,
        step_unclamped=lambda x, u, p: _step(x, u, p, False, normalize_quat),
        # the normalize_quat=True variant renormalizes inside the step: its
        # Jacobian is not the polynomial one (the kernel's jvp sweep forms it)
        jac_lanes=None if normalize_quat else _jac_lanes,
        kernel_step=step,
        device_env=DEVICE_ENV_NORM if normalize_quat else DEVICE_ENV,
        lower=torch.tensor(LOWER),
        upper=torch.tensor(UPPER),
        mpc_eps=1e-3,
        linesearch_decay=0.2,
        max_linesearch_iter=5,
    )
