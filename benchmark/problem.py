"""A configuration made concrete: the inputs both sides get, the program's
objects (the system under test, ``dilqr_tpu_torch``), and the plain
reference's.

The configuration states float32 with TF32 off. Its params, cost and bounds
are made once as float32 tensors on the card and handed to both sides; the
reference reads them in its own precision (float64 for the exact checks).
"""
from __future__ import annotations

import importlib

import torch

from benchmark import spec


class Problem:
    def __init__(self, name: str, device):
        self.name = name
        self.cfg = cfg = spec.config(name)
        self.model = spec.config_model(name)
        self.device = torch.device(device)
        if cfg["dtype"] != "float32":
            raise ValueError(f"{name}: the harness runs float32 configurations")
        if cfg["tf32"]:
            raise ValueError(f"{name}: the harness runs with TF32 off")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        f32 = dict(dtype=torch.float32, device=self.device)
        self.nx, self.nu, self.T = cfg["n_state"], cfg["n_ctrl"], cfg["T"]
        self.params = torch.tensor(cfg["params"], **f32)
        self.q = torch.tensor(cfg["q"], **f32)
        self.p = torch.tensor(cfg["p"], **f32)
        self.lo, self.hi = float(cfg["u_lower"]), float(cfg["u_upper"])

    def start(self, gen: torch.Generator, B: int) -> torch.Tensor:
        return self.model.start(gen, B, self.cfg["start"])

    # -- the program -----------------------------------------------------
    def program(self):
        """(MPC, dynamics, cost) of the port for serving (no backward)."""
        P = importlib.import_module("dilqr_tpu_torch")
        models = importlib.import_module(f"dilqr_tpu_torch.models.{self.cfg['program_model']}")
        c = self.cfg
        mpc = P.MPC(self.nx, self.nu, self.T, u_lower=self.lo, u_upper=self.hi,
                    lqr_iter=c["lqr_iter"], grad_method=P.GradMethod[c["grad_method"]],
                    eps=c["eps"], linesearch_decay=c["linesearch_decay"],
                    max_linesearch_iter=c["max_linesearch_iter"],
                    not_improved_lim=c["not_improved_lim"], best_cost_eps=c["best_cost_eps"],
                    exit_unconverged=False, detach_unconverged=False, backprop=False)
        return mpc, models.make(), P.QuadCost(torch.diag(self.q), self.p)

    # -- the reference ---------------------------------------------------
    def solve_reference(self, x0, u0, tile: int, rnd=None):
        """The plain reference's solve from x0 [B, nx] and the warm start u0
        [B, T, nu] or None, in float32; time-major results."""
        from benchmark.reference import ilqr

        c = self.cfg
        kw = {} if rnd is None else {"rnd": rnd}
        return ilqr.solve(self.model.step, self.model.jac, self.params, x0,
                          None if u0 is None else u0.transpose(0, 1).contiguous(),
                          torch.diag(self.q), self.p, self.lo, self.hi, nu=self.nu, T=self.T,
                          lqr_iter=c["lqr_iter"], eps=c["eps"],
                          linesearch_decay=c["linesearch_decay"],
                          max_linesearch_iter=c["max_linesearch_iter"],
                          not_improved_lim=c["not_improved_lim"],
                          best_cost_eps=c["best_cost_eps"], tile=tile, **kw)
