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
csrc/ilqr_fused.cuh (``Dynamics.device_mlp`` carries its widths). A net of
one hidden layer also has its hand Jacobian ``jac_lanes``, the reference's
``grad_input`` (dynamics.py:81-130), which ``Mlp::jac`` forms in the
pass that forms x' under either GradMethod (the step has no clamp, so
both differentiate the same function). Its solves on the card run
the whole-solve kernel (csrc/ilqr_mlp.cu, one library per shape) up to
``weight_limit`` weights: ``MAX_STREAMED_PARAMS`` = 1,205 for one hidden
layer -- the learned cartpole model's, the default hidden 100
(``models/cartpole_mlp``) -- and JAX's ``MAX_PYTREE_PARAMS`` = 256 for a
deeper net. Past that, and without ``hidden_sizes``, they run the plain
loop, whose Riccati backward is the CUDA Riccati kernel on the card
(ops/cuda/riccati_fused.py).
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


def _sigmoid_grad(a):
    s = torch.sigmoid(a)
    return s * (1.0 - s)


# each activation's derivative at the pre-activation, as Mlp::jac (and
# torch's forward mode: relu'(0) = 0, elu'(0) = 1) forms it
ACT_GRADS = {
    "sigmoid": _sigmoid_grad,
    "relu": lambda a: (a > 0.0).to(a.dtype),
    "elu": lambda a: torch.where(a > 0.0, torch.ones_like(a), torch.expm1(a) + 1.0),
}
# EnvId of the MLP's device code in csrc/ilqr_fused.cuh (its slew-rate
# wrapper's is models/ctrl_passthrough.DEVICE_ENVS[DEVICE_ENV])
DEVICE_ENV = 10
# the most weights JAX's whole-solve kernel takes as flat scalars
# (MAX_PYTREE_PARAMS, dilqr_tpu/ops/pallas/ilqr_fused.py:405): its SMEM
# scalar vector holds every weight, and so does flat_params, its mirror
MAX_PYTREE_PARAMS = 256
# the most weights the port's kernel takes for a net of one hidden layer.
# The port's kernel holds no copy of the weights: each is read
# in place through the read-only cache, one warp-wide load at a time (Mlp
# in csrc/ilqr_fused.cuh), and Mlp streams the last hidden layer into the
# output one unit at a time, so such a net holds no per-thread array of it.
# The step and Mlp::jac are unrolled over every weight, so the code grows
# with them: 1,205, the learned cartpole model's (models/cartpole_mlp), is
# the largest net built, checked for stack and spills and timed against the
# plain loop on the card; a larger one runs the plain loop. A deeper net
# holds each earlier hidden layer per thread and keeps JAX's 256.
MAX_STREAMED_PARAMS = 1205


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


def weight_limit(spec: Optional[MlpSpec]) -> int:
    """The most weights the kernel takes for an MLP of ``spec`` (None: a
    model without MLP widths, whose pytree keeps JAX's limit)."""
    if spec is not None and len(spec.hidden) == 1:
        return MAX_STREAMED_PARAMS
    return MAX_PYTREE_PARAMS


def flat_params(params, limit: int = MAX_PYTREE_PARAMS) -> Optional[torch.Tensor]:
    """The weights [(W, b), ...] as one vector [P] in JAX's ravel_pytree
    order (W0 row-major, b0, W1, b1, ...), the kernel's params; None for
    params that are not a non-empty list or tuple of (W, b) tensor pairs,
    or past ``limit`` weights (by default JAX's, _flatten_pytree_params;
    the kernel route passes ``weight_limit``)."""
    if not isinstance(params, (list, tuple)) or not params:
        return None
    leaves = []
    for layer in params:
        if not (isinstance(layer, (list, tuple)) and len(layer) == 2
                and all(isinstance(a, torch.Tensor) for a in layer)):
            return None
        leaves += [a.reshape(-1) for a in layer]
    if sum(a.numel() for a in leaves) > limit:
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
            # W [out, in] or per example [..., out, in]
            z = (z @ W.transpose(-1, -2) if W.dim() == 2 else (W @ z[..., None])[..., 0]) + b
            if i < len(params) - 1:
                z = act(z)
        return z + x if passthrough else z

    if hidden_sizes is None:
        return Dynamics(n_state=n_state, n_ctrl=n_ctrl, step=step_arrays)

    spec = MlpSpec(n_state, n_ctrl, tuple(int(h) for h in hidden_sizes), activation,
                   passthrough)
    sizes = (n_state + n_ctrl,) + spec.hidden + (n_state,)
    nz = n_state + n_ctrl
    act_grad = ACT_GRADS[activation]

    def layers(p):
        """(W [..., nout, nin], b [..., nout]) of each layer from the flat
        weights p [P] or per example [..., P]."""
        off, out = 0, []
        for nin, nout in zip(sizes[:-1], sizes[1:]):
            W = p[..., off:off + nout * nin].reshape(p.shape[:-1] + (nout, nin))
            out.append((W, p[..., off + nout * nin:off + (nin + 1) * nout]))
            off += (nin + 1) * nout
        return out

    def kernel_step(x, u, p):
        """x' from the flat weights p [P], or [..., P] that broadcast with x
        (a plant with weights of its own per example), each row summed as
        JAX's step_scalars sums it (dilqr_tpu/models/nn_dynamics.py:92-112)
        and the kernel's Mlp: the products over the inputs in order, then
        the bias."""
        z = torch.cat([x, u], -1)
        for li, (W, b) in enumerate(layers(p)):
            s = z[..., 0:1] * W[..., :, 0]
            for j in range(1, W.shape[-1]):
                s = s + z[..., j:j + 1] * W[..., :, j]
            s = s + b
            z = act(s) if li < len(sizes) - 2 else s
        return z + x if passthrough else z

    def jac_lanes(x, u, p):
        """D = [dx'/dx | dx'/du] [..., nx, nx + nu] of one hidden layer, the
        reference's grad_input (dynamics.py:81-130) in the order Mlp::jac
        forms it: with a = W1 z + b1 summed as kernel_step sums it, D =
        sum over the hidden units h in order of W2[:, h] (act'(a_h)
        W1[h, :]), then I added where passthrough."""
        (W1, b1), (W2, _) = layers(p)
        z = torch.cat([x, u], -1)
        a = z[..., 0:1] * W1[..., :, 0]
        for j in range(1, nz):
            a = a + z[..., j:j + 1] * W1[..., :, j]
        g = act_grad(a + b1)
        D = None
        for h in range(W1.shape[-2]):
            t = W2[..., :, h, None] * (g[..., h, None] * W1[..., h, :])[..., None, :]
            D = t if D is None else D + t
        if passthrough:
            D = D + torch.eye(n_state, nz, dtype=D.dtype, device=D.device)
        return D

    def step(x, u, params):
        if isinstance(params, torch.Tensor):
            return kernel_step(x, u, params)
        return step_arrays(x, u, params)

    return Dynamics(n_state=n_state, n_ctrl=n_ctrl, step=step, kernel_step=kernel_step,
                    jac_lanes=jac_lanes if len(spec.hidden) == 1 else None,
                    device_env=DEVICE_ENV, device_mlp=spec)
