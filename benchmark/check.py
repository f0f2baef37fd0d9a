"""The comparison that decides ``correct``: the solves the window made,
sampled from the seed, each at the timed batch, against the plain reference
on the same inputs.

Numbers, each the worst over the sampled solves (``limits/<cell>.json``
holds each one's limit):

 * ``traj_res``: x[0] against the start and x[t+1] against the model's step
   of (x[t], u[t]), recomputed in float64; the largest |gap| / (1 + |x|).
 * ``box_violation``: how far any control lies outside the box (exact: 0).
 * ``cost_res``: each example's returned cost against the objective of its
   returned (x, u), recomputed in float64; |gap| / max(|objective|, 1).
 * ``plant_res`` (closed loops): the plant's next state against the plant's
   step of (start, first action) at the example's params, in float64.
 * ``opt_gap``: how much worse the returned plan is than the reference
   solver's from the same start and warm start, in float32 with the
   program's per-tile decisions; the mean over the examples of
   max(0, J - J_ref) / max(|J_ref|, 1).
 * ``opt_gap_max``: the largest of those gaps, so that one example's worse
   plan is not diluted by the batch.

``control`` puts the reference, computed in TF32, in the program's place.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.precision import tf32

NAMES = ("traj_res", "box_violation", "cost_res", "plant_res", "opt_gap", "opt_gap_max")


def _rel(a, b):
    return ((a - b).abs() / (1.0 + b.abs())).max().item()


def _objective64(prob, X, U):
    tau = torch.cat([X, U], -1).double()
    C, c = torch.diag(prob.q).double(), prob.p.double()
    return (0.5 * (tau * (tau @ C.T)).sum(-1) + (tau * c).sum(-1)).sum(-1)


def numbers(prob, sample: dict) -> dict:
    """The numbers of one sampled solve; ``sample`` holds x_in [B, nx], u0
    [B, T, nu] or None, X [B, T, nx], U [B, T, nu], costs [B] and, for a
    closed loop, x_next [B, nx] and plant_params [B, P]."""
    nx, nu, T = prob.nx, prob.nu, prob.T
    X, U, x_in = sample["X"], sample["U"], sample["x_in"]
    B = X.shape[0]
    p64 = prob.params.double()
    nxt = prob.model.step(X[:, :-1].double().reshape(-1, nx), U[:, :-1].double().reshape(-1, nu),
                          p64).reshape(B, T - 1, nx)
    out = {"traj_res": max(_rel(X[:, 0].double(), x_in.double()),
                           _rel(X[:, 1:].double(), nxt))}
    out["box_violation"] = max(float((prob.lo - U).clamp(min=0).max()),
                               float((U - prob.hi).clamp(min=0).max()))
    J = _objective64(prob, X, U)
    out["cost_res"] = ((sample["costs"].double() - J).abs() / J.abs().clamp(min=1.0)).max().item()
    if "x_next" in sample:
        plant = prob.model.step(x_in.double(), U[:, 0].double(), sample["plant_params"].double())
        out["plant_res"] = _rel(sample["x_next"].double(), plant)
    ref = prob.solve_reference(x_in, sample["u0"], tile=1024)
    Jr = ref.costs.double()
    gap = (J - Jr).clamp(min=0.0) / Jr.abs().clamp(min=1.0)
    out["opt_gap"] = gap.mean().item()
    out["opt_gap_max"] = gap.max().item()
    return out


def control(prob, sample: dict) -> dict:
    """The sample with the program's outputs replaced by the reference's,
    computed in TF32 (solve and plant step)."""
    ref = prob.solve_reference(sample["x_in"], sample["u0"], tile=1024, rnd=tf32)
    out = dict(sample, X=ref.x.transpose(0, 1), U=ref.u.transpose(0, 1), costs=ref.costs)
    if "x_next" in sample:
        out["x_next"] = tf32(prob.model.step(sample["x_in"], out["U"][:, 0],
                                             sample["plant_params"]))
    return out


def worst(readings) -> dict:
    """The worst of each number over the sampled solves (NaN wins)."""
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = v if k not in out or math.isnan(v) or v > out[k] else out[k]
    return out


def judge(values: dict, limits: dict, failed: int):
    """(correct, {name: {"value", "limit"}}) over the numbers with a limit;
    every limited number must be there, finite and within its limit, and no
    example of the window may have failed."""
    checks, ok = {}, failed == 0
    for name in NAMES:
        if name not in limits:
            continue
        v = values.get(name, math.nan)
        checks[name] = {"value": v, "limit": limits[name]}
        ok = ok and not math.isnan(v) and v <= limits[name]
    return ok, checks
