"""The operations and bytes one whole iLQR solve needs, from the problem's
shapes and from the iterations and line-search rollouts each example needs
by the algorithm's own stopping rule, as the plain reference
(``reference/ilqr.py`` with ``tile`` = 1) finds them on the same inputs.
Nothing here reads the program's own counters.

Operations, per example (the arithmetic of reference/ilqr.py, multiply and
add counted apart):

 * the first rollout: T steps and T objectives;
 * each iteration: T Jacobians and T Riccati steps, each with its box-QP
   counted at one Newton step and one Armijo trial (``qp_flops``; further
   box-QP iterations depend on the data and are not counted);
 * each line-search rollout: T of (K dx, the new control and its clamp, the
   objective, the step).

The model's step, Jacobian and box-QP costs are the configuration's
(``work`` in its JSON file). Bytes: every input read once (the start, the
warm start if there is one, the cost, the params, the bounds) and every
output written once (x, u, the costs, the step norms), 4 bytes a float.
"""
from __future__ import annotations

FP32_PEAK = 67e12  # NVIDIA H100 SXM, float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12  # NVIDIA H100 SXM device memory, bytes/s


def riccati_flops(nx: int, nu: int) -> int:
    """One Riccati step of the reference, without the box-QP."""
    n = nx + nu
    return (2 * nx * nx * n          # V^T F
            + 2 * n * nx * n + n * n  # F^T (V F), + C
            + 2 * n * n + 2 * n       # C tau + c
            + 2 * n * nx + n          # + F^T v
            + 2 * nu * nu * nx        # K
            + 2 * nx * nu * nx        # M = Q_xu K
            + 2 * nu * nu * nx + 2 * nx * nu * nx + 3 * nx * nx  # V
            + 4 * nx * nu + 4 * nu * nu + 2 * nx)  # v


def objective_flops(n: int) -> int:
    return 2 * n * n + 3 * n


def trial_flops(nx: int, nu: int, step_flops: int) -> int:
    """One step of a line-search rollout."""
    return 2 * nu * nx + 4 * nu + objective_flops(nx + nu) + step_flops


def _total(v) -> int:
    return int(v.sum()) if hasattr(v, "sum") else sum(int(a) for a in v)


def solve_flops(cfg: dict, iters, trials) -> float:
    """Operations of one solve; iters and trials are per-example sequences
    (or tensors) of equal length, the batch."""
    nx, nu, T = cfg["n_state"], cfg["n_ctrl"], cfg["T"]
    w = cfg["work"]
    first = T * (w["step_flops"] + objective_flops(nx + nu))
    per_iter = T * (w["jac_flops"] + riccati_flops(nx, nu) + w["qp_flops"])
    per_trial = T * trial_flops(nx, nu, w["step_flops"])
    return float(len(iters) * first + per_iter * _total(iters) + per_trial * _total(trials))


def solve_bytes(cfg: dict, B: int, warm: bool) -> float:
    nx, nu, T = cfg["n_state"], cfg["n_ctrl"], cfg["T"]
    n = nx + nu
    reads = B * nx + (T * B * nu if warm else 0) + n * n + n + len(cfg["params"]) + 2 * nu
    writes = T * B * (nx + nu) + 2 * B
    return 4.0 * (reads + writes)


def least_seconds(flops: float, nbytes: float):
    """(seconds, "operations" or "bytes"): the least time on the card."""
    t_ops, t_by = flops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_by), ("operations" if t_ops >= t_by else "bytes")
