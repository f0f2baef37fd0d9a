"""The comparison that decides ``correct`` fails the TF32 control and each
fault a cell can have, and passes the sound program, at a size a CPU test
holds (one tile, the port's plain loop standing in for the card)."""
from __future__ import annotations

import pytest
import torch

import cpu_cells

LOOP, PLAN, ROCKET = ("cartpole.mpc_loop.b65536", "cartpole.plan_batch.b131072",
                      "rocket.mpc_loop.b16384")


@pytest.mark.parametrize("workload", [LOOP, PLAN, ROCKET])
def test_control_in_lower_precision_fails(workload):
    from benchmark import calibrate, check, spec

    wl = spec.workload(spec.benchmark(), workload)
    mode = spec.traffic(wl["traffic"])["mode"]
    with cpu_cells.cpu_run():
        rows, failed = calibrate.readings(wl, 98765432101, 8.0, True, "cpu",
                                          cpu_cells.SMALL[mode])
    prog = [n for k, n in rows if k == "program"]
    ctl = [n for k, n in rows if k == "control"]
    assert prog and ctl
    limits = spec.limits(workload)
    assert check.judge(check.worst(prog), limits, failed)[0] is True
    assert check.judge(check.worst(ctl), limits, failed)[0] is False


class Faulty:
    """The program with one fault planted where its answer is produced."""

    def __init__(self, prob, fault: str):
        self.prob, self.fault = prob, fault
        self.real = type(prob).program(prob)

    def __call__(self):
        mpc, dyn, cost = self.real
        outer = self

        class Mpc:
            def solve(self, x, cost_, dyn_, params=None, u_init=None):
                res = mpc.solve(x, cost_, dyn, params=params, u_init=u_init)
                return outer.answer_fault(res, x, u_init, dyn, params)

        class Dyn:
            def step(self, x, a, p):
                xn = dyn.step(x, a, p)
                return x if outer.fault == "plant_unchanged" else xn

        return Mpc(), Dyn() if self.fault == "plant_unchanged" else dyn, cost

    def answer_fault(self, res, x, u_init, dyn, params):
        B, T, nu = res.u.shape
        if self.fault == "altered":
            u = res.u.clone()
            u[B // 3, T // 2] += 0.5
            return res._replace(u=u)
        if self.fault == "one_worse":
            return self.one_worse(res, x, dyn, params)
        if self.fault not in ("unchanged", "half"):
            return res
        # the warm start handed back as the answer, with its own rollout and
        # objective, for every example ("unchanged") or the second half
        u0 = torch.zeros_like(res.u) if u_init is None else u_init
        xs = [x]
        for t in range(T - 1):
            xs.append(dyn.step(xs[-1], u0[:, t], params))
        X = torch.stack(xs, 1)
        tau = torch.cat([X, u0], -1)
        C, c = torch.diag(self.prob.q), self.prob.p
        J = (0.5 * (tau * (tau @ C.T)).sum(-1) + (tau * c).sum(-1)).sum(-1)
        keep = torch.arange(B) < (B // 2 if self.fault == "half" else 0)
        return res._replace(x=torch.where(keep[:, None, None], res.x, X),
                            u=torch.where(keep[:, None, None], res.u, u0),
                            costs=torch.where(keep, res.costs, J))

    def one_worse(self, res, x, dyn, params):
        """One example's plan pushed 5% of the box off the optimum, with its
        own rollout and objective: consistent, inside the box, and worse
        than the reference's; the other examples as solved."""
        k = res.u.shape[0] // 3
        u = res.u[k:k + 1] + 0.05 * self.prob.hi
        u = u.clamp(self.prob.lo, self.prob.hi)
        xs = [x[k:k + 1]]
        for t in range(u.shape[1] - 1):
            xs.append(dyn.step(xs[-1], u[:, t], params))
        X = torch.stack(xs, 1)
        tau = torch.cat([X, u], -1)
        C, c = torch.diag(self.prob.q), self.prob.p
        J = (0.5 * (tau * (tau @ C.T)).sum(-1) + (tau * c).sum(-1)).sum(-1)
        xo, uo, co = res.x.clone(), res.u.clone(), res.costs.clone()
        xo[k], uo[k], co[k] = X[0], u[0], J[0]
        return res._replace(x=xo, u=uo, costs=co)


@pytest.mark.parametrize("workload,fault", [
    (LOOP, "unchanged"), (LOOP, "half"), (LOOP, "altered"), (LOOP, "plant_unchanged"),
    (LOOP, "one_worse"), (PLAN, "unchanged"), (PLAN, "half"), (PLAN, "altered"),
    (PLAN, "one_worse")])
def test_each_fault_comes_out_not_correct(workload, fault):
    from benchmark import spec
    from benchmark.problem import Problem

    wl = spec.workload(spec.benchmark(), workload)
    holder = {}

    def program():
        if "f" not in holder:
            holder["f"] = Faulty(Problem(wl["config"], "cpu"), fault)
        return holder["f"]()

    r = cpu_cells.run_small(workload, program=program)
    assert r["correct"] is False, r["checks"]
    if fault == "one_worse":  # caught by the widest gap, whatever the batch
        gap = r["checks"]["opt_gap_max"]
        assert gap["value"] > gap["limit"], r["checks"]


@pytest.mark.parametrize("workload", [LOOP, PLAN])
def test_sound_program_comes_out_correct(workload):
    r = cpu_cells.run_small(workload)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1024
