"""How far f32 rounding alone moves a rocket solve, beside how far the
whole-solve kernel is from its plain version on the same inputs.

    python -m dilqr_tpu_torch.tools.rounding_witness --B 1030 --T 20 \\
        --lqr-iter 3 --eps 0 --hi 0.3,0.05,0.05 [--ladder] [--device cpu]

bench.py's rocket start (``rocket.bench_start``, seed 1, after ``--skip``
states drawn and dropped) is solved with the bounds +-hi through the
kernel (``ilqr_fused``) and its plain version (``ilqr_fused_reference``),
and each again from the start scaled by (1 + ``--nudge``), one or two ulp
of every component at the default 2e-7. Three pairs are compared: kernel
against plain, kernel against kernel nudged, plain against plain nudged.
The plain version and its
nudged run share PyTorch's summation order and the kernel has its own, so
the kernel's own pair is the witness for the kernel's distance to the
plain version: where kernel-vs-plain is no larger than the two self
pairs, what separates the versions is what rounding makes of this
problem, not a different function. ``--ladder`` repeats this for
lqr_iter = 1 .. L (with eps 0 each run is a prefix of the next), which
shows the iteration where the pairs part.

Each pair prints: max |du| per control, the examples past 2e-3 and the
max on the examples converged in both runs (du < eps), max |dx|, the
largest relative cost difference and the examples past 1e-4 (per
1024-example tile), the share of controls at a bound and the active-set
entries (|u - bound| < 1e-6) that differ, per control and per step, and
both runs' n_iter. On the CPU the kernel's place is taken by the plain
version, so kernel-vs-plain is zero there.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from ..models import rocket
from ..ops.cuda import ilqr_fused as fused
from ..types import ILQRConfig


def at_bound(u, lo, hi):
    """[T, B, nu] bool: u within 1e-6 of its lower or upper bound."""
    return ((u - lo).abs() < 1e-6) | ((u - hi).abs() < 1e-6)


def distances(a, b, lo, hi, eps):
    """Distances between two ilqr_fused outputs (x [T,B,nx], u [T,B,nu],
    costs [B], du [B], n_iter), as a dict of plain Python numbers. The
    examples "converged" are those whose best iterate has du < eps in both:
    their u is set by the problem, not by the path the iterations took."""
    du = (a[1] - b[1]).abs()
    rel = (a[2] - b[2]).abs() / b[2].abs().clamp(min=1e-6)
    tiles = [rel[g:g + fused.TILE] for g in range(0, rel.shape[0], fused.TILE)]
    conv = (a[3] < eps) & (b[3] < eps)
    act_a = at_bound(a[1], lo, hi)
    miss = act_a != at_bound(b[1], lo, hi)
    return {
        "u_max": du.amax(dim=(0, 1)).tolist(),
        "u_past_2e-3": int((du.amax(dim=(0, 2)) > 2e-3).sum()),
        "converged": int(conv.sum()),
        "u_max_converged": du[:, conv].amax(dim=(0, 1)).tolist() if bool(conv.any()) else None,
        "x_max": (a[0] - b[0]).abs().max().item(),
        "cost_rel_max": rel.max().item(),
        "cost_past_1e-4_per_tile": [int((r > 1e-4).sum()) for r in tiles],
        "active_share": act_a.float().mean(dim=(0, 1)).tolist(),
        "active_mismatch": miss.sum(dim=(0, 1)).tolist(),
        "active_mismatch_per_step": miss.sum(dim=(1, 2)).tolist(),
        "n_iter": [int(a[4]), int(b[4])],
    }


def describe(d) -> str:
    """One line of a distances dict."""
    conv = ("none" if d["u_max_converged"] is None
            else str(['%.2e' % v for v in d["u_max_converged"]]))
    return (f"u max per control {['%.2e' % v for v in d['u_max']]} (examples past 2e-3: "
            f"{d['u_past_2e-3']}; on the {d['converged']} converged in both: {conv}), x max "
            f"{d['x_max']:.2e}, cost rel max {d['cost_rel_max']:.2e} (past 1e-4 per tile: "
            f"{d['cost_past_1e-4_per_tile']}), active share per control "
            f"{['%.3f' % v for v in d['active_share']]}, active-set mismatches per control "
            f"{d['active_mismatch']}, per step {d['active_mismatch_per_step']}, n_iter "
            f"{d['n_iter']}")


def witness(cfg, dyn, params, x0, cost_small, lo, hi, nudge=2e-7):
    """{pair: distances} for the three pairs of the module docstring."""
    x1 = x0 * (1.0 + nudge)
    args = (cfg, dyn, params)
    k0, k1 = (fused.ilqr_fused(*args, x, cost_small, None, lo, hi) for x in (x0, x1))
    p0, p1 = (fused.ilqr_fused_reference(*args, x, cost_small, None, lo, hi) for x in (x0, x1))
    return {"kernel vs plain": distances(k0, p0, lo, hi, cfg.eps),
            "kernel vs kernel nudged": distances(k0, k1, lo, hi, cfg.eps),
            "plain vs plain nudged": distances(p0, p1, lo, hi, cfg.eps)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=1030)
    ap.add_argument("--T", type=int, default=20)
    ap.add_argument("--lqr-iter", type=int, default=15)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--hi", default="0.3,0.05,0.05", help="per-control bound, +-hi")
    ap.add_argument("--skip", type=int, default=0,
                    help="states drawn and dropped first (chip_smoke.py's phase 3 draws 1024 "
                         "before its ragged rocket batch)")
    ap.add_argument("--nudge", type=float, default=2e-7)
    ap.add_argument("--ladder", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    dyn, params = rocket.make(), rocket.default_params(device=dev)
    q, p = rocket.get_true_obj(device=dev)
    hi = torch.tensor([float(v) for v in a.hi.split(",")], device=dev)
    gen = torch.Generator().manual_seed(1)
    rocket.bench_start(a.skip, gen)
    x0 = rocket.bench_start(a.B, gen, device=dev)
    cfg = ILQRConfig(
        n_state=13, n_ctrl=3, T=a.T, lqr_iter=a.lqr_iter, eps=a.eps,
        linesearch_decay=dyn.linesearch_decay, max_linesearch_iter=dyn.max_linesearch_iter,
        exit_unconverged=False, detach_unconverged=False, backprop=False)
    for L in range(1, a.lqr_iter + 1) if a.ladder else (a.lqr_iter,):
        c = dataclasses.replace(cfg, lqr_iter=L)
        for pair, d in witness(c, dyn, params, x0, (torch.diag(q), p), -hi, hi, a.nudge).items():
            print(f"witness B={a.B} T={a.T} lqr_iter={L} eps={a.eps:g} hi={a.hi} {pair}: "
                  f"{describe(d)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
