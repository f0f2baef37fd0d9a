"""RMSprop as ``optax.rmsprop(learning_rate, decay)`` computes it, the
optimizer of the imitation-learning trainer (dilqr_tpu/il/exp.py:103) and
of bench.py's train step:

    nu     = decay * nu + (1 - decay) * g^2        (nu starts at 0)
    update = -lr * g / sqrt(nu + eps)

eps sits inside the square root, unlike ``torch.optim.RMSprop``, which adds
it outside. Plain functions over a dict of tensors: the state is a dict of
the same keys.
"""
from __future__ import annotations

from typing import Dict

import torch


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
