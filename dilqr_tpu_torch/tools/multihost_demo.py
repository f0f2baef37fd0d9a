"""Multi-process launcher of the port (counterpart of
scripts/multihost_demo.py): the batch-sharded solve, a warm-started solve
and one distributed imitation-learning step on torch.distributed, each held
against the one-process program computed on the rank's own device, and the
collectives audit.

Run the same command on every rank:

  torchrun (N GPUs, NCCL; the environment gives the ranks):
      torchrun --nproc-per-node N -m dilqr_tpu_torch.tools.multihost_demo

  a local cluster (what the CPU tests and chip_smoke.py start, see launch):
      python -m dilqr_tpu_torch.tools.multihost_demo --init file:///tmp/store \\
          --world-size 2 --rank I --device cpu [--backend gloo]

``--batches 3,5,2,3`` gives each rank its own batch size: equal sizes run
the even mode (solve, warm start, train step, audit), unequal ones the
uneven mode (distribute_batch_padded with its validity mask, a strict
equal-share solve, audit). ``--problem`` is the JAX demo's pendulum (T=8,
lqr_iter 6) or bench.py's cartpole (T=20, box +-100, lqr_iter 20).

The one-process reference is ``solve`` on the whole batch, on the rank's
own device. Where both programs take the same path it is met to 1e-6 in u
and the train step to 1e-6 in the parameters and 1e-7 in the loss (JAX's
bars; relative past a loss of 1): on a card when a rank's share is whole
tiles, since the whole-solve kernel decides per 1024-example tile (the
same bits, which the run reports), and on the host at float64, where the
plain loop decides for the whole batch over all ranks (parallel/comm.py)
and a rank's smaller batch changes only the last bits. Elsewhere, in
float32 on the host (a batch of another size rounds otherwise, and at a
converged example accept or reject in the line search follows the
rounding) or with tiles cut otherwise, the examples converged in both are
held to chip_smoke.py's parity bounds (costs 1e-4 relative, u 2e-2, x 1e-2)
and the train step to 1e-4. Rank 0 writes the gathered results to
``--out`` (.npz); every rank prints ``MULTIHOST OK ...`` and exits 0, or
exits 1.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from ..core.solver import solve
from ..models import cartpole, pendulum
from ..ops.cuda import ilqr_fused, kkt_fused, riccati_fused
from ..parallel import audit
from ..parallel import multihost as mh
from ..types import BackwardMode, ILQRConfig, QuadCost
from ..utils.optim import rmsprop

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KERNELS = (ilqr_fused, kkt_fused, riccati_fused)  # launches are reported in this order


def problem(name: str, dtype, device):
    """(cfg, dyn, params, q, p) of the JAX demo's pendulum or bench.py's
    cartpole, IFT backward."""
    env = {"pendulum": pendulum, "cartpole": cartpole}[name]
    dyn = env.make()
    T, lqr_iter, eps = (8, 6, 1e-4) if name == "pendulum" else (20, 20, dyn.mpc_eps)
    cfg = ILQRConfig(n_state=dyn.n_state, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=eps,
                     linesearch_decay=dyn.linesearch_decay,
                     max_linesearch_iter=dyn.max_linesearch_iter, exit_unconverged=False,
                     detach_unconverged=False, backward_mode=BackwardMode.IFT)
    q, p = env.get_true_obj(dtype=dtype, device=device)
    return cfg, dyn, env.default_params(dtype=dtype, device=device), q, p


def starts(name: str, B: int) -> np.ndarray:
    """The whole batch's initial states, the same on every rank: the JAX
    demo's pendulum sweep, or bench.py's cartpole start (angle pi/1.05 +
    N(0, 0.1), numpy seed 0)."""
    if name == "pendulum":
        th = np.linspace(-1.2, 1.2, B)
        return np.stack([np.cos(th), np.sin(th), np.linspace(-0.5, 0.5, B)], 1)
    th = np.pi / 1.05 + 0.1 * np.random.RandomState(0).randn(B)
    z = np.zeros(B)
    return np.stack([z, z, np.cos(th), np.sin(th), z], 1)


def one_process_step(cfg, dyn, opt, params, state, x, ue, q, p):
    """The reference train step on the whole batch (JAX demo's local_step)."""
    pr = params.detach().clone().requires_grad_(True)
    res = solve(cfg, x, QuadCost(torch.diag(q), p), dyn, params=pr, u_lower=dyn.lower,
                u_upper=dyn.upper)
    loss = ((res.u - ue) ** 2).mean()
    (g,) = torch.autograd.grad(loss, pr)
    new, state = opt.update(params, g, state)
    return new, state, loss.detach()


def exact(device: torch.device, dtype, shares) -> bool:
    """Whether the sharded solve takes the one-process program's path."""
    if device.type == "cuda":
        return all(s % ilqr_fused.TILE == 0 for s in shares)
    return dtype == torch.float64


def check_solve(label: str, got, ref, eps: float, is_exact: bool) -> dict:
    """got, ref: (x, u, costs, full_du_norm) of the whole batch."""
    x, u, c, du = got
    rx, ru, rc, rdu = ref
    ex_u = (u - ru).abs().amax(dim=(1, 2))
    ex_x = (x - rx).abs().amax(dim=(1, 2))
    rel = (c - rc).abs() / rc.abs().clamp(min=1e-6)
    out = {"bits": all(torch.equal(a, b) for a, b in zip(got, ref)),
           "u": ex_u.max().item(), "x": ex_x.max().item(), "cost_rel": rel.max().item()}
    if is_exact:
        if out["u"] > 1e-6:
            raise RuntimeError(f"{label}: u {out['u']:.2e} from the one-process solve")
        return out
    conv = (du < eps) & (rdu < eps)
    if not bool(conv.any()):
        raise RuntimeError(f"{label}: no example converged in both")
    out.update(converged=int(conv.sum()), u=ex_u[conv].max().item(), x=ex_x[conv].max().item(),
               cost_rel=rel[conv].max().item())
    if out["cost_rel"] > 1e-4 or out["u"] > 2e-2 or out["x"] > 1e-2:
        raise RuntimeError(f"{label}: converged examples past (1e-4, 2e-2, 1e-2): {out}")
    return out


def _zero_launches():
    for m in KERNELS:
        m.LAUNCHES = 0


def _read_launches():
    return [m.LAUNCHES for m in KERNELS]


def _stats(recs, batch):
    colls, big = audit.audit_collectives(recs, batch)
    if big:
        raise RuntimeError(f"per-example collective crossed ranks: {big}")
    return len(colls), sum(c.numel for c in colls)


def even_mode(args, mesh, counts, dtype):
    dev, r, W = mesh.device, mesh.rank, mesh.world_size
    Bl, Bg = counts[r], sum(counts)
    cfg, dyn, params0, q, p = problem(args.problem, dtype, dev)
    cost = QuadCost(torch.diag(q), p)
    box = dict(u_lower=dyn.lower, u_upper=dyn.upper)
    x_full = torch.as_tensor(starts(args.problem, Bg), dtype=dtype, device=dev)
    lo = r * Bl
    is_exact = exact(dev, dtype, counts)
    fields = ("x", "u", "costs", "full_du_norm")

    def whole(res):
        return tuple(getattr(res, f) for f in fields)

    # the distributed solve against the one-process solve of the whole batch
    ref = solve(cfg, x_full, cost, dyn, params=params0, **box)
    _zero_launches()
    with audit.recording() as recs_solve:
        res = mh.multihost_solve(mesh, cfg, x_full[lo:lo + Bl], cost, dyn, params=params0, **box)
    l_solve = _read_launches()
    got = mh.gather(mesh, whole(res))
    err_solve = check_solve("solve", got, whole(ref), cfg.eps, is_exact)

    # per-example keyword arguments: a [B_local, T, nu] warm start
    u0 = torch.as_tensor(0.05 * np.random.RandomState(17).randn(Bg, cfg.T, 1), dtype=dtype,
                         device=dev)
    ref_w = solve(cfg, x_full, cost, dyn, params=params0, u_init=u0, **box)
    res_w = mh.multihost_solve(mesh, cfg, x_full[lo:lo + Bl], cost, dyn, params=params0,
                               u_init=u0[lo:lo + Bl], **box)
    got_w = mh.gather(mesh, whole(res_w))
    err_warm = check_solve("warm start", got_w, whole(ref_w), cfg.eps, is_exact)

    # one distributed train step against the one-process step: each rank
    # trains on the first N examples of its share
    N = args.train_batch or Bl
    xt = torch.cat([x_full[k * Bl:k * Bl + N] for k in range(W)])
    ue = torch.zeros(W * N, cfg.T, 1, dtype=dtype, device=dev)
    opt = rmsprop(1e-2, decay=0.5)
    p_ref, _, loss_ref = one_process_step(cfg, dyn, opt, params0, opt.init(params0), xt, ue, q, p)
    step = mh.multihost_train_step(mesh, cfg, dyn, opt)
    _zero_launches()
    with audit.recording() as recs_step:
        p_new, _, loss = step(params0, opt.init(params0), xt[r * N:(r + 1) * N],
                              ue[r * N:(r + 1) * N], q, p)
    l_step = _read_launches()
    err_params = (p_new - p_ref).abs().max().item()
    err_loss = abs(loss.item() - loss_ref.item())
    tol_p, tol_l = (1e-6, 1e-7) if exact(dev, dtype, [N] * W) else (1e-4, 1e-4)
    if err_params > tol_p or err_loss > tol_l * max(1.0, abs(loss_ref.item())):
        raise RuntimeError(f"train step: params {err_params:.2e}, loss {err_loss:.2e}")
    if not (p_new - params0).abs().max().item() > 0:
        raise RuntimeError("train step: the parameters did not move")
    if W > 1:  # a global batch the ranks do not divide is refused, on every rank
        try:
            step(params0, opt.init(params0), xt[r * N:(r + 1) * N - (r == 0)],
                 ue[r * N:(r + 1) * N - (r == 0)], q, p)
        except ValueError as e:
            if "distribute_batch_padded" not in str(e):
                raise
        else:
            raise RuntimeError("train step: took a global batch the ranks do not divide")

    n_solve, e_solve = _stats(recs_solve, Bg)
    n_step, e_step = _stats(recs_step, Bg)
    launches = mh.gather(mesh, torch.tensor([l_solve + l_step], device=dev))
    out = dict(mode="even", counts=np.array(counts), x_init=x_full.cpu().numpy(),
               u=got[1].cpu().numpy(), x=got[0].cpu().numpy(), costs=got[2].cpu().numpy(),
               full_du_norm=got[3].cpu().numpy(), n_iter=int(res.n_iter),
               u_warm=got_w[1].cpu().numpy(), u0=u0.cpu().numpy(),
               train_batch=N, params=p_new.detach().cpu().numpy(), loss=loss.item(),
               params_ref=p_ref.detach().cpu().numpy(), loss_ref=loss_ref.item(),
               bits_solve=err_solve["bits"], bits_warm=err_warm["bits"],
               err_solve=err_solve["u"], err_warm=err_warm["u"], err_params=err_params,
               err_loss=err_loss, exact=is_exact,
               collectives_solve=[n_solve, e_solve], collectives_step=[n_step, e_step],
               launches=launches.cpu().numpy())
    line = (f"B_global={Bg} err_solve={err_solve['u']:.2e} bits={err_solve['bits']} "
            f"err_warm={err_warm['u']:.2e} err_params={err_params:.2e} loss={loss.item():.6f} "
            f"collectives solve {n_solve} ({e_solve} elements) step {n_step} ({e_step} "
            f"elements), 0 large; launches (ilqr, kkt, riccati) solve {l_solve} step {l_step}")
    return out, line


def uneven_mode(args, mesh, counts, dtype):
    dev, r, W = mesh.device, mesh.rank, mesh.world_size
    Bg = sum(counts)
    cfg, dyn, params0, q, p = problem(args.problem, dtype, dev)
    cost = QuadCost(torch.diag(q), p)
    box = dict(u_lower=dyn.lower, u_upper=dyn.upper)
    x_full = torch.as_tensor(starts(args.problem, Bg), dtype=dtype, device=dev)
    fields = ("x", "u", "costs", "full_du_norm")

    # the padded path: arbitrary uneven shards
    lo = sum(counts[:r])
    (xg,), valid, B = mh.distribute_batch_padded(mesh, (x_full[lo:lo + counts[r]],))
    if B != Bg or xg.shape[0] * W < Bg or xg.device != dev:
        raise RuntimeError(f"distribute_batch_padded: B={B}, share {tuple(xg.shape)}")
    ref = solve(cfg, x_full, cost, dyn, params=params0, **box)
    _zero_launches()
    with audit.recording() as recs_solve:
        res = mh.multihost_solve(mesh, cfg, xg, cost, dyn, params=params0, **box)
    l_solve = _read_launches()
    got = mh.gather(mesh, tuple(getattr(res, f) for f in fields))
    v = mh.gather(mesh, valid)
    if not (bool(v[:Bg].all()) and not bool(v[Bg:].any())):
        raise RuntimeError(f"validity mask {v.tolist()}")
    err_pad = check_solve("padded solve", tuple(a[:Bg] for a in got),
                          tuple(getattr(ref, f) for f in fields), cfg.eps,
                          exact(dev, dtype, [xg.shape[0]] * W))

    # the strict path: an equal share a rank (whole tiles on a card)
    tile = ilqr_fused.TILE
    per = tile if dev.type == "cuda" and Bg >= tile * W else 2
    xs = x_full[:per * W]
    ref2 = solve(cfg, xs, cost, dyn, params=params0, **box)
    (xl,), layout = mh.distribute_batch(mesh, (xs[r * per:(r + 1) * per],))
    if layout.counts != (per,) * W or layout.offset(r) != r * per:
        raise RuntimeError(f"distribute_batch layout {layout}")
    res2 = mh.multihost_solve(mesh, cfg, xl, cost, dyn, params=params0, **box)
    got2 = mh.gather(mesh, tuple(getattr(res2, f) for f in fields))
    err_strict = check_solve("strict solve", got2, tuple(getattr(ref2, f) for f in fields),
                             cfg.eps, exact(dev, dtype, [per] * W))

    n_solve, e_solve = _stats(recs_solve, Bg)
    launches = mh.gather(mesh, torch.tensor([l_solve], device=dev))
    out = dict(mode="uneven", counts=np.array(counts), x_init=x_full.cpu().numpy(),
               valid=v.cpu().numpy(), u=got[1][:Bg].cpu().numpy(), x=got[0][:Bg].cpu().numpy(),
               costs=got[2][:Bg].cpu().numpy(), full_du_norm=got[3][:Bg].cpu().numpy(),
               n_iter=int(res.n_iter), strict_per_rank=per, u_strict=got2[1].cpu().numpy(),
               err_pad=err_pad["u"], bits_pad=err_pad["bits"], err_strict=err_strict["u"],
               bits_strict=err_strict["bits"], converged_pad=err_pad.get("converged", Bg),
               collectives_solve=[n_solve, e_solve], launches=launches.cpu().numpy())
    line = (f"B_global={Bg} (uneven {list(counts)}, padded to {xg.shape[0] * W}) "
            f"err_pad={err_pad['u']:.2e} bits={err_pad['bits']} err_strict={err_strict['u']:.2e} "
            f"collectives solve {n_solve} ({e_solve} elements), 0 large; launches (ilqr, kkt, "
            f"riccati) solve {l_solve}")
    return out, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", default=None, help="the store: file:///path or tcp://host:port")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--device", default=None, help="this rank's device (default cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--problem", default="pendulum", choices=("pendulum", "cartpole"))
    ap.add_argument("--batches", default=None,
                    help="comma list of per-rank batch sizes (default 8 a rank)")
    ap.add_argument("--train-batch", type=int, default=None,
                    help="examples a rank in the train step (default: its whole share)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--out", default=None, help=".npz that rank 0 writes")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective waits for the other ranks")
    args = ap.parse_args(argv)
    mh.initialize(args.init, args.world_size, args.rank, device=args.device,
                  backend=args.backend, timeout=args.timeout)
    try:
        mesh = mh.global_batch_mesh()
        W = mesh.world_size
        counts = ([int(s) for s in args.batches.split(",")] if args.batches else [8] * W)
        if len(counts) != W:
            raise ValueError(f"--batches has {len(counts)} sizes for {W} ranks")
        dtype = getattr(torch, args.dtype)
        mode = even_mode if len(set(counts)) == 1 else uneven_mode
        out, line = mode(args, mesh, counts, dtype)
        if mesh.rank == 0 and args.out:
            np.savez(args.out, **out)
        print(f"MULTIHOST OK rank {mesh.rank}/{W} device={mesh.device} "
              f"backend={torch.distributed.get_backend()} {line}", flush=True)
    finally:
        mh.shutdown()
    return 0


def launch(world_size: int, argv, timeout: float = 300.0, env=None):
    """Run the demo as a local cluster of ``world_size`` processes on a
    fresh file store, every rank with ``argv``. The first rank that fails
    and the timeout (seconds) end every rank. Returns the ranks' outputs;
    raises RuntimeError with their tails if any rank failed."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PKG_ROOT, env.get("PYTHONPATH")) if p)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one machine: the loopback device
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world_size)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dilqr_tpu_torch.tools.multihost_demo",
             "--init", f"file://{os.path.join(tmp, 'store')}", "--world-size", str(world_size),
             "--rank", str(r), *argv], stdout=logs[r], stderr=subprocess.STDOUT, cwd=PKG_ROOT,
            env=env) for r in range(world_size)]
        t_end, why = time.monotonic() + timeout, None
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    why = "a rank failed"
                    break
                if time.monotonic() > t_end:
                    why = f"timed out after {timeout:.0f} s"
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if why or any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{o[-3000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"cluster of {world_size}: {why or 'a rank failed'}\n{tails}")
    return outs


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # a rank's failure: the traceback, then exit 1
        traceback.print_exc()
        print(f"MULTIHOST FAILED: {e}", flush=True)
        sys.exit(1)
