"""MLP dynamics x' = MLP(x, u) (+ x with passthrough): the learned model
(counterpart of ``dilqr_tpu/models/nn_dynamics.py``, reference NNDynamics,
dynamics.py:15-130).

Params: the JAX pytree as tensors, a list of (W [out, in], b [out]) per
layer; hidden layers take the activation, the last layer none. The
Jacobian is forward-mode autodiff of the same step (core/linearize).

At the default width (hidden 100) a cartpole-sized model (5 states, 1
control) has 1,205 parameters: past the 256 the JAX whole-solve kernel
takes as flat scalars (ilqr_fused.py:405-428), so its solves run the plain
loop, whose Riccati backward is the CUDA Riccati kernel on the card
(ops/cuda/riccati_fused.py). ``hidden_sizes`` is accepted for API parity;
the JAX step's scalar-list form, which serves only that kernel, is not
ported (ROADMAP.md, queue B item 4).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as tnf

from .base import Dynamics

ACTS = {
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "elu": tnf.elu,
}


def init_params(n_state: int, n_ctrl: int, hidden_sizes: Sequence[int] = (100,),
                generator: Optional[torch.Generator] = None, device=None,
                dtype=torch.float32) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """torch.nn.Linear-style init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for W
    and b, as the JAX init draws them (its jax.random bits differ)."""
    sizes = [n_state + n_ctrl] + list(hidden_sizes) + [n_state]

    def uniform(shape, bound):
        r = torch.rand(shape, generator=generator, dtype=torch.float64)
        return ((2.0 * r - 1.0) * bound).to(dtype=dtype, device=device)

    return [(uniform((n_out, n_in), n_in ** -0.5), uniform((n_out,), n_in ** -0.5))
            for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def make(n_state: int, n_ctrl: int, activation: str = "sigmoid", passthrough: bool = True,
         hidden_sizes: Optional[Sequence[int]] = None) -> Dynamics:
    """The step broadcasts over leading batch dims: x [..., nx], u [..., nu]."""
    if activation not in ACTS:
        raise ValueError(f"activation must be one of {sorted(ACTS)}, got {activation!r}")
    act = ACTS[activation]

    def step(x, u, params):
        z = torch.cat([x, u], -1)
        for i, (W, b) in enumerate(params):
            z = z @ W.transpose(-1, -2) + b
            if i < len(params) - 1:
                z = act(z)
        return z + x if passthrough else z

    return Dynamics(n_state=n_state, n_ctrl=n_ctrl, step=step)
