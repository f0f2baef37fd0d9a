"""The trainer's optimizers as optax computes them. Plain functions over a
dict of tensors; the state is a dict of the same keys (Adam: its moments
under "mu" and "nu" and its step count under "count").

``rmsprop_*``: ``optax.rmsprop(learning_rate, decay)``, the optimizer of
the imitation-learning trainer's MPC modes (dilqr_tpu/il/exp.py:103) and
of bench.py's train step:

    nu     = decay * nu + (1 - decay) * g^2        (nu starts at 0)
    update = -lr * g / sqrt(nu + eps)

eps sits inside the square root, unlike ``torch.optim.RMSprop``, which adds
it outside. ``rmsprop(learning_rate, decay, eps)`` is optax's constructor:
an ``Optimizer`` whose init and update take any pytree of tensors (the
multi-rank train step's, parallel/multihost.py).

``adam_*``: ``optax.adam(learning_rate)`` with b1 0.9, b2 0.999, eps 1e-8
and eps_root 0, the optimizer of the trainer's mode 'nn'
(dilqr_tpu/il/exp.py:95):

    mu     = b1 * mu + (1 - b1) * g                (mu, nu start at 0)
    nu     = b2 * nu + (1 - b2) * g^2
    n      = count + 1
    update = -lr * (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch
from torch.utils import _pytree as pytree


def rmsprop_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def rmsprop_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                   nu: Dict[str, torch.Tensor], lr: float = 1e-2, decay: float = 0.5,
                   eps: float = 1e-8):
    """One step. Returns (new params, new state); the inputs are not
    modified."""
    new_nu = {k: decay * nu[k] + (1.0 - decay) * grads[k] * grads[k] for k in params}
    new_params = {k: params[k] - lr * grads[k] / torch.sqrt(new_nu[k] + eps) for k in params}
    return new_params, new_nu


class Optimizer(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (params, grads, state) -> (new params, new state)


def rmsprop(learning_rate: float, decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """``optax.rmsprop(learning_rate, decay, eps)`` over a pytree of
    tensors, by ``rmsprop_update`` on its leaves."""

    def init(params):
        return pytree.tree_map(torch.zeros_like, params)

    def update(params, grads, nu):
        spec = pytree.tree_structure(params)
        new, new_nu = rmsprop_update(*(dict(enumerate(pytree.tree_leaves(t)))
                                       for t in (params, grads, nu)),
                                     lr=learning_rate, decay=decay, eps=eps)
        return tuple(pytree.tree_unflatten(list(d.values()), spec) for d in (new, new_nu))

    return Optimizer(init, update)


def adam_init(params: Dict[str, torch.Tensor]) -> dict:
    return {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": 0}


def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
                lr: float = 1e-4, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step. Returns (new params, new state); the inputs are not
    modified."""
    mu = {k: (1.0 - b1) * grads[k] + b1 * state["mu"][k] for k in params}
    nu = {k: (1.0 - b2) * grads[k] * grads[k] + b2 * state["nu"][k] for k in params}
    n = state["count"] + 1
    c1, c2 = 1.0 - b1 ** n, 1.0 - b2 ** n
    new_params = {k: params[k] - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
                  for k in params}
    return new_params, {"mu": mu, "nu": nu, "count": n}
