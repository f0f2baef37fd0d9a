"""The plain reference of the ``cartpole`` configuration (cartpole.json):
mpc.pytorch's cartpole (the DiLQR reference's env_dx/cartpole.py), 5 states
(x, x_dot, cos th, sin th, th_dot), 1 control (the force), Euler with
dt = 0.05, params (gravity, masscart, masspole, length), in plain PyTorch.

The step is the form the program's whole-solve kernel states (the angle
advanced by the angle-addition identities and renormalized), which differs
from the atan2 form at rounding only; the Jacobian is its hand-derived one.
Both work in the dtype of their inputs, so the check runs them in float64.
"""
from __future__ import annotations

import torch

DT = 0.05
FORCE_MAG = 100.0


def _params(p, like):
    return torch.as_tensor(p, dtype=like.dtype, device=like.device).unbind(-1)


def _rotate(c, s, delta):
    cd, sd = torch.cos(delta), torch.sin(delta)
    ct, st = c * cd - s * sd, s * cd + c * sd
    nn = ct * ct + st * st
    r = torch.rsqrt(torch.clamp(nn, min=1e-30))
    zero = nn == 0.0
    return torch.where(zero, cd, ct * r), torch.where(zero, sd, st * r)


def step(state, u, params):
    """x' [..., 5] from x [..., 5], u [..., 1] and params [4] or [..., 4]."""
    gravity, masscart, masspole, length = _params(params, state)
    total_mass = masspole + masscart
    pml = masspole * length
    uu = torch.clamp(u[..., 0], -FORCE_MAG, FORCE_MAG)
    x, dx, c, s, w = state.unbind(-1)
    cart_in = (uu + pml * w ** 2 * s) / total_mass
    th_acc = (gravity * s - c * cart_in) / (length * (4.0 / 3.0 - masspole * c ** 2 / total_mass))
    xacc = cart_in - pml * th_acc * c / total_mass
    nc, ns = _rotate(c, s, DT * w)
    return torch.stack([x + DT * dx, dx + DT * xacc, nc, ns, w + DT * th_acc], -1)


def jac(state, u, params):
    """[dx'/dx | dx'/du] [..., 5, 6] of the un-clamped step."""
    gravity, masscart, masspole, length = _params(params, state)
    tm = masspole + masscart
    pml = masspole * length
    dt = DT
    x, v, c, s, w = state.unbind(-1)
    uu = u[..., 0]
    zero, one = torch.zeros_like(c), torch.ones_like(c)
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
    cd, sd = torch.cos(delta), torch.sin(delta)
    ct, st = c * cd - s * sd, s * cd + c * sd
    r = torch.rsqrt(torch.clamp(ct * ct + st * st, min=1e-30))
    r2 = r * r
    A_c = ct * cd + st * sd
    A_s = -ct * sd + st * cd
    o3, o4 = ct * r, st * r
    rows = [
        [one, dt + zero, zero, zero, zero, zero],
        [zero, one, dt * xacc_c, dt * xacc_s, dt * xacc_w, dt * xacc_u],
        [zero, zero, r * (cd - ct * A_c * r2), r * (-sd - ct * A_s * r2), -dt * o4, zero],
        [zero, zero, r * (sd - st * A_c * r2), r * (cd - st * A_s * r2), dt * o3, zero],
        [zero, zero, dt * ta_c, dt * ta_s, one + dt * ta_w, dt * ta_u],
    ]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def start(gen: torch.Generator, B: int, spec: dict, dtype=torch.float32):
    """Starts [B, 5] on gen's device: th = mean + std N(0, 1), at rest at the
    origin (bench.py:121-156)."""
    th = spec["theta_mean"] + spec["theta_std"] * torch.randn(
        B, generator=gen, device=gen.device, dtype=torch.float64)
    z = torch.zeros_like(th)
    return torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dtype)

