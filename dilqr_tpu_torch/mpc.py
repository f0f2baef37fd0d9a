"""Reference-compatible MPC wrapper class (counterpart of
``dilqr_tpu/mpc.py``), on top of the functional solver. Arrays are
batch-major [B, T, ...]; dynamics are a models.base.Dynamics plus a
separate params tensor (or LinDx)."""
from __future__ import annotations

from typing import Optional

from .core.solver import solve
from .types import BackwardMode, GradMethod, ILQRConfig


class MPC:
    def __init__(
        self,
        n_state: int,
        n_ctrl: int,
        T: int,
        u_lower=None,
        u_upper=None,
        u_zero_I=None,
        u_init=None,
        lqr_iter: int = 10,
        grad_method: GradMethod = GradMethod.ANALYTIC,
        delta_u=None,
        verbose: int = 0,
        eps: float = 1e-7,
        back_eps: Optional[float] = None,
        n_batch: Optional[int] = None,
        linesearch_decay: float = 0.2,
        max_linesearch_iter: int = 10,
        exit_unconverged: bool = True,
        detach_unconverged: bool = True,
        backprop: bool = True,
        slew_rate_penalty: Optional[float] = None,
        prev_ctrl=None,
        not_improved_lim: int = 5,
        best_cost_eps: float = 1e-4,
        backward_mode: BackwardMode = BackwardMode.KKT,
        unroll: bool = False,
        backend: str = "auto",
    ):
        if (u_lower is None) != (u_upper is None):
            raise ValueError("u_lower and u_upper must both be set or both None")
        if max_linesearch_iter <= 0:
            raise ValueError("max_linesearch_iter must be positive")
        self.cfg = ILQRConfig(
            n_state=n_state,
            n_ctrl=n_ctrl,
            T=T,
            lqr_iter=lqr_iter,
            grad_method=grad_method,
            eps=eps,
            back_eps=back_eps,
            linesearch_decay=linesearch_decay,
            max_linesearch_iter=max_linesearch_iter,
            exit_unconverged=exit_unconverged,
            detach_unconverged=detach_unconverged,
            backprop=backprop,
            not_improved_lim=not_improved_lim,
            best_cost_eps=best_cost_eps,
            backward_mode=backward_mode,
            slew_rate_penalty=slew_rate_penalty,
            unroll=unroll or backward_mode is BackwardMode.UNROLL,
            verbose=verbose,
            backend=backend,
        )
        self.u_lower = u_lower
        self.u_upper = u_upper
        self.u_zero_I = u_zero_I
        self.u_init = u_init
        self.delta_u = delta_u
        self.prev_ctrl = prev_ctrl
        self.verbose = verbose
        self.n_batch = n_batch

    def _check_batch(self, x_init):
        if self.n_batch is not None and x_init.shape[0] != self.n_batch:
            raise ValueError(
                f"x_init batch {x_init.shape[0]} != n_batch={self.n_batch} "
                "passed to MPC(...)"
            )

    def solve(self, x_init, cost, dx, params=None, u_init=None):
        """Full-result variant returning types.SolveResult."""
        self._check_batch(x_init)
        return solve(
            self.cfg, x_init, cost, dx, params=params,
            u_init=u_init if u_init is not None else self.u_init,
            u_lower=self.u_lower, u_upper=self.u_upper,
            u_zero_I=self.u_zero_I, delta_u=self.delta_u,
            prev_ctrl=self.prev_ctrl,
        )

    def __call__(self, x_init, cost, dx, params=None, u_init=None):
        """Solve. Returns (x [B,T,nx], u [B,T,nu], costs [B]), batch-major.
        ``u_init`` overrides the constructor warm start for this call."""
        res = self.solve(x_init, cost, dx, params=params, u_init=u_init)
        return res.x, res.u, res.costs
