"""The learned cartpole model: the reference's NNDynamics (josef-w/
Differentiable-iLQR dynamics.py:15-130, from locuslab/mpc.pytorch) at its
default widths on the cartpole's sizes, x' = x + W2 sigmoid(W1 [x; u] + b1)
+ b2 with 5 states, 1 control and one hidden layer of 100: 6 -> 100 -> 5,
1,205 weights. ``nn_dynamics.make`` with these widths, so its solves on the
card run the whole-solve kernel (``Mlp<5, 1, sigmoid, residual, 100>``, its
hand Jacobian under either GradMethod).

Its params are the weights, as the pytree [(W1, b1), (W2, b2)] or one flat
vector [1205] in ``nn_dynamics.flat_params``' order; a plant may take its
own per example, [B, 1205].
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from . import nn_dynamics
from .base import Dynamics

N_STATE, N_CTRL = 5, 1
HIDDEN = (100,)
ACTIVATION = "sigmoid"
N_WEIGHTS = (N_STATE + N_CTRL + 1) * HIDDEN[0] + (HIDDEN[0] + 1) * N_STATE


def make() -> Dynamics:
    """The model with its device code: sigmoid, passthrough, hidden (100,)."""
    return nn_dynamics.make(N_STATE, N_CTRL, activation=ACTIVATION, passthrough=True,
                            hidden_sizes=HIDDEN)


def init_params(seed: int, device=None, dtype=torch.float32
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Weights drawn as torch.nn.Linear draws them, U(+-1/sqrt(fan_in)) for
    W and b (``nn_dynamics.init_params``), from a CPU generator seeded with
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return nn_dynamics.init_params(N_STATE, N_CTRL, HIDDEN, generator=gen, device=device,
                                   dtype=dtype)


def flat_init_params(seed: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """``init_params(seed)`` as the flat vector [1205] (W1 row-major, b1,
    W2 row-major, b2)."""
    return torch.cat([a.reshape(-1) for layer in init_params(seed, device, dtype)
                      for a in layer])
