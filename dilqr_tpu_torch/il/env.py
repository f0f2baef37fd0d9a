"""Imitation-learning environment wrapper: expert-data generation and the
MPC call used in training (counterpart of ``dilqr_tpu/il/env.py``).

Data arrays are batch-major numpy [N, T, n_state + n_ctrl], as in the JAX
package and the shipped datasets (data/*.npz). The solves run on
``device`` (default "cuda": pass "cpu" to run on the CPU) in ``dtype``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.solver import solve
from ..models import cartpole, pendulum
from ..types import BackwardMode, GradMethod, ILQRConfig, QuadCost


def make_env(name: str, device=None, dtype=torch.float32):
    """(Dynamics, params, (q, p)) for a named env."""
    if name == "pendulum":
        dyn = pendulum.make(simple=True)
        params = pendulum.default_params(simple=True, dtype=dtype, device=device)
        qp = pendulum.get_true_obj(dtype=dtype, device=device)
    elif name == "pendulum-complex":
        dyn = pendulum.make(simple=False)
        params = torch.tensor([10.0, 1.0, 1.0, 1.0, 0.1], dtype=dtype, device=device)
        qp = pendulum.get_true_obj(dtype=dtype, device=device)
    elif name == "cartpole":
        dyn = cartpole.make()
        params = cartpole.default_params(dtype=dtype, device=device)
        qp = cartpole.get_true_obj(dtype=dtype, device=device)
    else:
        raise ValueError(name)
    return dyn, params, qp


def sample_xinit(gen: torch.Generator, env_name: str, n_batch: int, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """Initial-state distributions. The reference's cartpole branch
    multiplies every random term by 0, leaving the deterministic
    near-upside-down state th = pi/1.05 -- reproduced."""
    if env_name in ("pendulum", "pendulum-complex"):
        th = (torch.rand(n_batch, generator=gen, dtype=torch.float64) - 0.5) * math.pi
        thdot = 2.0 * torch.rand(n_batch, generator=gen, dtype=torch.float64) - 1.0
        x = torch.stack([th.cos(), th.sin(), thdot], 1)
    elif env_name == "cartpole":
        th = torch.full((n_batch,), math.pi / 1.05, dtype=torch.float64)
        z = torch.zeros(n_batch, dtype=torch.float64)
        x = torch.stack([z, z, th.cos(), th.sin(), z], 1)
    else:
        raise ValueError(env_name)
    return x.to(device=device, dtype=dtype)


@dataclasses.dataclass
class ILEnv:
    """Env, expert MPC configuration and train/val/test data arrays."""

    env: str
    lqr_iter: int = 100
    mpc_T: int = 35
    slew_rate_penalty: Optional[float] = None
    grad_method: GradMethod = GradMethod.ANALYTIC
    backward_mode: BackwardMode = BackwardMode.IFT
    # "pnqp" reproduces the reference's projected-Newton iterates (parity
    # tests); "auto" is the closed-form 1-D QP the kernel runs
    qp_solver: str = "auto"
    device: str = "cuda"
    dtype: torch.dtype = torch.float32

    train_data: Optional[np.ndarray] = None
    val_data: Optional[np.ndarray] = None
    test_data: Optional[np.ndarray] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.true_dx, self.true_params, (self.true_q, self.true_p) = make_env(
            self.env, device=self.device, dtype=self.dtype)

    def tensor(self, a) -> torch.Tensor:
        """A numpy array (or tensor) as a tensor on the env's device and dtype."""
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                               device=self.device).to(self.dtype)

    def mpc(self, params, xinit: torch.Tensor, q: torch.Tensor, p: torch.Tensor,
            u_init: Optional[torch.Tensor] = None, eps_override: Optional[float] = None,
            lqr_iter_override: Optional[int] = None, backprop: bool = True):
        """Batched box-constrained solve with a diagonal cost. Returns
        (x [B,T,nx], u [B,T,nu])."""
        dx = self.true_dx
        cfg = ILQRConfig(
            n_state=dx.n_state, n_ctrl=dx.n_ctrl, T=self.mpc_T,
            lqr_iter=lqr_iter_override or self.lqr_iter, grad_method=self.grad_method,
            eps=eps_override or dx.mpc_eps, linesearch_decay=dx.linesearch_decay,
            max_linesearch_iter=dx.max_linesearch_iter, exit_unconverged=False,
            detach_unconverged=True, backward_mode=self.backward_mode, backprop=backprop,
            slew_rate_penalty=self.slew_rate_penalty, qp_solver=self.qp_solver)
        res = solve(cfg, xinit, QuadCost(torch.diag(q), p), dx, params=params, u_init=u_init,
                    u_lower=dx.lower, u_upper=dx.upper)
        return res.x, res.u

    def _split(self, tau: np.ndarray, n_train: int, n_val: int, n_test: int):
        self.train_data = tau[:n_train]
        self.val_data = tau[n_train:n_train + n_val]
        self.test_data = tau[-n_test:]

    def populate_data(self, n_train: int, n_val: int, n_test: int, seed: int = 0):
        """One batched expert solve for all examples."""
        gen = torch.Generator().manual_seed(seed)
        n = n_train + n_val + n_test
        xinit = sample_xinit(gen, self.env, n, device=self.device, dtype=self.dtype)
        x, u = self.mpc(self.true_params, xinit, self.true_q, self.true_p, backprop=False)
        self._split(torch.cat([x, u], 2).cpu().numpy(), n_train, n_val, n_test)

    def populate_data2(self, n_train: int, n_val: int, n_test: int, seed: int = 0,
                       xinit=None):
        """Receding-horizon expert with the warm-start shift: the whole
        population rolls forward together, one batched solve per env step.
        xinit: optional [n_total, n_state] initial states overriding
        sample_xinit (parity tests inject the reference's draws)."""
        n = n_train + n_val + n_test
        dx, params = self.true_dx, self.true_params
        if xinit is None:
            x = sample_xinit(torch.Generator().manual_seed(seed), self.env, n,
                             device=self.device, dtype=self.dtype)
        else:
            x = self.tensor(xinit)
        u_init = None
        xs, us = [x], []
        with torch.no_grad():
            for _ in range(self.mpc_T):
                _, nom_u = self.mpc(params, x, self.true_q, self.true_p, u_init=u_init,
                                    backprop=False)
                a0 = nom_u[:, 0]
                us.append(a0)
                x = dx.step(x, a0, params)
                xs.append(x)
                # shift the warm start: drop the first action, append zero,
                # and duplicate the second-to-last (il_env.py:139-140)
                u_init = torch.cat([nom_u[:, 1:], torch.zeros_like(nom_u[:, :1])], 1)
                u_init[:, -2] = u_init[:, -3]
        tau = torch.cat([torch.stack(xs[:-1], 1), torch.stack(us, 1)], 2)
        self._split(tau.cpu().numpy(), n_train, n_val, n_test)
