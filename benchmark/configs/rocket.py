"""The plain reference of the ``rocket`` configuration (rocket.json): the
DiLQR reference's env_dx/rocket.py 6-DoF soft landing, 13 states (r[3],
v[3], q[4], w[3]), 3 controls (the thrust vector), Euler with dt = 0.1,
params (Jx, Jy, Jz, mass, l), the quaternion not renormalized, in plain
PyTorch: the direction-cosine matrix from the quaternion, gravity
(-10, 0, 0), dq = 0.5 Omega(w) q, the torque r_T_B x T_B with
r_T_B = (-l/2, 0, 0) and dw = J^-1 (torque - w x J w); the thrust clamped to
+-400 inside the step. The Jacobian is the step's, written out by hand.
Both work in the dtype of their inputs.
"""
from __future__ import annotations

import torch

DT = 0.1
MAX_THRUST = 400.0


def _params(p, like):
    return torch.as_tensor(p, dtype=like.dtype, device=like.device).unbind(-1)


def _dcm(q0, q1, q2, q3):
    """C_B_I entrywise: c[i][j]; the step uses its transpose."""
    return [
        [1 - 2 * (q2 * q2 + q3 * q3), 2 * (q1 * q2 + q0 * q3), 2 * (q1 * q3 - q0 * q2)],
        [2 * (q1 * q2 - q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3), 2 * (q2 * q3 + q0 * q1)],
        [2 * (q1 * q3 + q0 * q2), 2 * (q2 * q3 - q0 * q1), 1 - 2 * (q1 * q1 + q2 * q2)],
    ]


def step(x, u, params):
    """x' [..., 13] from x [..., 13], u [..., 3] and params [5] or [..., 5]."""
    Jx, Jy, Jz, mass, l = _params(params, x)
    v = [x[..., 3 + i] for i in range(3)]
    q0, q1, q2, q3 = (x[..., 6 + i] for i in range(4))
    w0, w1, w2 = (x[..., 10 + i] for i in range(3))
    TB = [torch.clamp(u[..., i], -MAX_THRUST, MAX_THRUST) for i in range(3)]
    c = _dcm(q0, q1, q2, q3)
    g = (-10.0, 0.0, 0.0)
    dv = [(c[0][i] * TB[0] + c[1][i] * TB[1] + c[2][i] * TB[2]) / mass + g[i] for i in range(3)]
    dq = [0.5 * (-w0 * q1 - w1 * q2 - w2 * q3), 0.5 * (w0 * q0 + w2 * q2 - w1 * q3),
          0.5 * (w1 * q0 - w2 * q1 + w0 * q3), 0.5 * (w2 * q0 + w1 * q1 - w0 * q2)]
    a = -0.5 * l
    cw0 = w1 * (Jz * w2) - w2 * (Jy * w1)
    cw1 = w2 * (Jx * w0) - w0 * (Jz * w2)
    cw2 = w0 * (Jy * w1) - w1 * (Jx * w0)
    dw = [(0.0 - cw0) / Jx, (-a * TB[2] - cw1) / Jy, (a * TB[1] - cw2) / Jz]
    return x + torch.stack(v + dv + dq + dw, -1) * DT


def jac(x, u, params):
    """[dx'/dx | dx'/du] [..., 13, 16] of the un-clamped step."""
    Jx, Jy, Jz, mass, l = _params(params, x)
    dt = DT
    q0, q1, q2, q3 = (x[..., 6 + i] for i in range(4))
    w0, w1, w2 = (x[..., 10 + i] for i in range(3))
    T = [u[..., 0], u[..., 1], u[..., 2]]
    zero, one = torch.zeros_like(q0), torch.ones_like(q0)
    c = _dcm(q0, q1, q2, q3)
    dc = {  # d c[i][j] / d (q0, q1, q2, q3)
        (0, 0): [zero, zero, -4 * q2, -4 * q3],
        (0, 1): [2 * q3, 2 * q2, 2 * q1, 2 * q0],
        (0, 2): [-2 * q2, 2 * q3, -2 * q0, 2 * q1],
        (1, 0): [-2 * q3, 2 * q2, 2 * q1, -2 * q0],
        (1, 1): [zero, -4 * q1, zero, -4 * q3],
        (1, 2): [2 * q1, 2 * q0, 2 * q3, 2 * q2],
        (2, 0): [2 * q2, 2 * q3, 2 * q0, 2 * q1],
        (2, 1): [-2 * q1, -2 * q0, 2 * q3, 2 * q2],
        (2, 2): [zero, -4 * q1, -4 * q2, zero],
    }
    rows = [[zero] * 16 for _ in range(13)]
    for i in range(3):
        rows[i][i] = one
        rows[i][3 + i] = dt + zero
    for m in range(3):
        i = 3 + m
        rows[i][i] = one
        for k in range(4):
            rows[i][6 + k] = dt * (dc[(0, m)][k] * T[0] + dc[(1, m)][k] * T[1]
                                   + dc[(2, m)][k] * T[2]) / mass
        for j in range(3):
            rows[i][13 + j] = dt * c[j][m] / mass
    h = 0.5 * dt
    qjac = [
        ([zero, -h * w0, -h * w1, -h * w2], [-h * q1, -h * q2, -h * q3]),
        ([h * w0, zero, h * w2, -h * w1], [h * q0, -h * q3, h * q2]),
        ([h * w1, -h * w2, zero, h * w0], [h * q3, h * q0, -h * q1]),
        ([h * w2, h * w1, -h * w0, zero], [-h * q2, h * q1, h * q0]),
    ]
    for a in range(4):
        dqq, dqw = qjac[a]
        for b in range(4):
            rows[6 + a][6 + b] = dqq[b] + (one if a == b else zero)
        for b in range(3):
            rows[6 + a][10 + b] = dqw[b]
    kzy, kxz, kyx = Jz - Jy, Jx - Jz, Jy - Jx
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


def start(gen: torch.Generator, B: int, spec: dict, dtype=torch.float32):
    """Starts [B, 13] on gen's device: mean + std N(0, 1) for each state, the
    means and standard deviations the spec lists (bench.py:318-324)."""
    mean = torch.tensor(spec["mean"], dtype=torch.float64, device=gen.device)
    std = torch.tensor(spec["std"], dtype=torch.float64, device=gen.device)
    z = torch.randn(B, mean.shape[0], generator=gen, device=gen.device, dtype=torch.float64)
    return (mean + std * z).to(dtype)
