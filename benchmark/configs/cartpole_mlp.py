"""The plain reference of the ``cartpole_mlp`` configuration
(cartpole_mlp.json): the learned cartpole model, the DiLQR reference's
NNDynamics (dynamics.py:15-130, from mpc.pytorch) at its default widths on
the cartpole's sizes, x' = x + W2 sigmoid(W1 [x; u] + b1) + b2 with 5
states, 1 control and 100 hidden units, in plain PyTorch.

The weights are one flat vector [1205] (W1 [100, 6] row-major, b1, W2 [5,
100] row-major, b2), or one such vector per example [..., 1205]. The
Jacobian is the reference's analytic grad_input (dynamics.py:81-130):
W2 diag(sigmoid'(a)) W1, plus I for the passthrough. Both work in the dtype
of their inputs, so the check runs them in float64; the starts are the
cartpole's (cartpole.py beside this file).
"""
from __future__ import annotations

import torch

NX, NU, NH = 5, 1, 100
NZ = NX + NU


def _layers(params, like):
    """(W1 [..., 100, 6], b1 [..., 100], W2 [..., 5, 100], b2 [..., 5])."""
    p = torch.as_tensor(params, dtype=like.dtype, device=like.device)
    lead = p.shape[:-1]
    o1, o2 = NH * NZ, NH * NZ + NH
    o3 = o2 + NX * NH
    return (p[..., :o1].reshape(lead + (NH, NZ)), p[..., o1:o2],
            p[..., o2:o3].reshape(lead + (NX, NH)), p[..., o3:o3 + NX])


def _pre(state, u, params):
    W1, b1, W2, b2 = _layers(params, state)
    z = torch.cat([state, u], -1)
    return (W1 @ z[..., None])[..., 0] + b1, W1, W2, b2


def step(state, u, params):
    """x' [..., 5] from x [..., 5], u [..., 1] and the weights [1205] or
    [..., 1205]."""
    a, _, W2, b2 = _pre(state, u, params)
    return state + (W2 @ torch.sigmoid(a)[..., None])[..., 0] + b2


def jac(state, u, params):
    """[dx'/dx | dx'/du] [..., 5, 6]: W2 diag(s (1 - s)) W1 + [I | 0]."""
    a, W1, W2, _ = _pre(state, u, params)
    s = torch.sigmoid(a)
    D = W2 @ ((s * (1.0 - s))[..., None] * W1)
    return D + torch.eye(NX, NZ, dtype=D.dtype, device=D.device)


def start(gen: torch.Generator, B: int, spec: dict, dtype=torch.float32):
    """Starts [B, 5] on gen's device: the cartpole's (th = mean + std N(0,
    1), at rest at the origin, as cos th and sin th)."""
    th = spec["theta_mean"] + spec["theta_std"] * torch.randn(
        B, generator=gen, device=gen.device, dtype=torch.float64)
    z = torch.zeros_like(th)
    return torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dtype)
