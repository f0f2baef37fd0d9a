"""MLP dynamics x' = MLP(x, u) (+ x with passthrough): the learned model
(counterpart of ``dilqr_tpu/models/nn_dynamics.py``, reference NNDynamics,
dynamics.py:15-130).

Params: the JAX pytree as tensors, a list of (W [out, in], b [out]) per
layer; hidden layers take the activation, the last layer none. The
Jacobian is forward-mode autodiff of the same step (core/linearize).

With ``hidden_sizes`` given, the model also has device code: the step's
kernel form ``kernel_step`` over the flat weight vector of ``flat_params``
(JAX's ravel_pytree order, each layer's W row-major then its b), the
counterpart of JAX's ``step_scalars``, and ``Mlp<...>`` in
csrc/ilqr_fused.cuh (``Dynamics.device_mlp`` carries its widths). Up to
``MAX_PYTREE_PARAMS`` = 256 weights, as JAX flattens them into its
whole-solve kernel (ilqr_fused.py:405-428), its solves on the card run the
whole-solve kernel (csrc/ilqr_mlp.cu, one library per shape); past that --
the default hidden 100 of a cartpole-sized model has 1,205 -- and without
``hidden_sizes`` they run the plain loop, whose Riccati backward is the
CUDA Riccati kernel on the card (ops/cuda/riccati_fused.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as tnf

from .base import Dynamics, MlpSpec

ACTS = {
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "elu": tnf.elu,
}
# EnvId of the MLP's device code in csrc/ilqr_fused.cuh (its slew-rate
# wrapper's is models/ctrl_passthrough.DEVICE_ENVS[DEVICE_ENV])
DEVICE_ENV = 10
# the most weights JAX's whole-solve kernel takes as flat scalars
# (MAX_PYTREE_PARAMS, dilqr_tpu/ops/pallas/ilqr_fused.py:405)
MAX_PYTREE_PARAMS = 256


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


def flat_params(params) -> Optional[torch.Tensor]:
    """The weights [(W, b), ...] as one vector [P] in JAX's ravel_pytree
    order (W0 row-major, b0, W1, b1, ...), the kernel's params; None for
    params that are not a non-empty list or tuple of (W, b) tensor pairs,
    or past MAX_PYTREE_PARAMS weights (JAX's _flatten_pytree_params)."""
    if not isinstance(params, (list, tuple)) or not params:
        return None
    leaves = []
    for layer in params:
        if not (isinstance(layer, (list, tuple)) and len(layer) == 2
                and all(isinstance(a, torch.Tensor) for a in layer)):
            return None
        leaves += [a.reshape(-1) for a in layer]
    if sum(a.numel() for a in leaves) > MAX_PYTREE_PARAMS:
        return None
    return torch.cat(leaves)


def make(n_state: int, n_ctrl: int, activation: str = "sigmoid", passthrough: bool = True,
         hidden_sizes: Optional[Sequence[int]] = None) -> Dynamics:
    """The step broadcasts over leading batch dims: x [..., nx], u [..., nu].
    With ``hidden_sizes`` it also takes the flat weights of flat_params,
    and the model has device code (see the module docstring)."""
    if activation not in ACTS:
        raise ValueError(f"activation must be one of {sorted(ACTS)}, got {activation!r}")
    act = ACTS[activation]

    def step_arrays(x, u, params):
        z = torch.cat([x, u], -1)
        for i, (W, b) in enumerate(params):
            z = z @ W.transpose(-1, -2) + b
            if i < len(params) - 1:
                z = act(z)
        return z + x if passthrough else z

    if hidden_sizes is None:
        return Dynamics(n_state=n_state, n_ctrl=n_ctrl, step=step_arrays)

    spec = MlpSpec(n_state, n_ctrl, tuple(int(h) for h in hidden_sizes), activation,
                   passthrough)
    sizes = (n_state + n_ctrl,) + spec.hidden + (n_state,)

    def kernel_step(x, u, p):
        """x' from the flat weights p [P] (flat_params), each row summed as
        JAX's step_scalars sums it (dilqr_tpu/models/nn_dynamics.py:92-112) and the
        kernel's Mlp: the products over the inputs in order, then the
        bias."""
        z = torch.cat([x, u], -1)
        off = 0
        for li, (nin, nout) in enumerate(zip(sizes[:-1], sizes[1:])):
            W = p[off:off + nout * nin].reshape(nout, nin)
            b = p[off + nout * nin:off + (nin + 1) * nout]
            off += (nin + 1) * nout
            s = z[..., 0:1] * W[:, 0]
            for j in range(1, nin):
                s = s + z[..., j:j + 1] * W[:, j]
            s = s + b
            z = act(s) if li < len(sizes) - 2 else s
        return z + x if passthrough else z

    def step(x, u, params):
        if isinstance(params, torch.Tensor):
            return kernel_step(x, u, params)
        return step_arrays(x, u, params)

    return Dynamics(n_state=n_state, n_ctrl=n_ctrl, step=step, kernel_step=kernel_step,
                    device_env=DEVICE_ENV, device_mlp=spec)
