#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dilqr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. require a CUDA device; print the card's name and power limit;
  2. build every CUDA kernel of the main path from csrc/ (nvcc, sm_90a),
     in parallel, and print the build seconds and the ptxas report;
  3. hold each kernel against its plain PyTorch version on the card, on the
     same inputs, at the shapes of the main path;
  4. drive the main path through its entry points -- MPC.solve (what
     MPC.__call__ runs) on cartpole at B=4096 and B=16384 and
     receding_horizon at B=1024 -- with
     every launch counter set to 0 just before and read just after;
  5. time the kernels (CUDA events, warm-up, median) and print one JSON
     line with each kernel's numbers;
  6. print the nvidia-smi line, then the result line
     {"ok": true, "device": {...}} last.

It imports nothing of JAX and nothing of the JAX package. The weights of
this system are the dynamics parameters and the cost; they are the
cartpole's published defaults, and the initial states come from a seed.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SEED = 0
FP32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int, reps: int):
    """Median milliseconds of fn() on the card, CUDA events around each run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def main():
    import torch

    # ---- 1) the card ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import dilqr_tpu_torch as P
    from dilqr_tpu_torch.control import receding_horizon
    from dilqr_tpu_torch.models import cartpole, pendulum
    from dilqr_tpu_torch.ops.cuda import build
    from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused

    dev = torch.device("cuda:0")
    kernels = {"ilqr_fused": fused}

    # ---- 2) build ----
    t0 = time.perf_counter()
    reports = build.build_all([m.SOURCE for m in kernels.values()])
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(reports)} source(s)", flush=True)
    for src, rep in reports.items():
        for line in rep.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "error")):
                print(f"ptxas[{src}]: {line.strip()}", flush=True)

    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def cartpole_x0(B):
        th = math.pi / 1.05 + 0.1 * torch.randn(B, generator=gen)
        z = torch.zeros(B)
        return torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)

    def pendulum_x0(B):
        th = -1.5 + 3.0 * torch.rand(B, generator=gen)
        w = 0.5 * torch.randn(B, generator=gen)
        return torch.stack([th.cos(), th.sin(), w], 1).to(dev)

    def cfg_for(dyn, nx, T, lqr_iter, eps):
        return P.ILQRConfig(
            n_state=nx, n_ctrl=1, T=T, lqr_iter=lqr_iter, eps=eps,
            linesearch_decay=dyn.linesearch_decay,
            max_linesearch_iter=dyn.max_linesearch_iter,
            exit_unconverged=False, detach_unconverged=False, backprop=False)

    cp_dyn, cp_params = cartpole.make(), cartpole.default_params(device=dev)
    cp_q, cp_p = cartpole.get_true_obj(device=dev)
    pd_dyn, pd_params = pendulum.make(), pendulum.default_params(device=dev)
    pd_q, pd_p = pendulum.get_true_obj(device=dev)
    T = 20
    bench_cfg = cfg_for(cp_dyn, 5, T, 20, cp_dyn.mpc_eps)

    # ---- 3) kernel against its plain version on the card ----
    # Tolerances (f32). n_iter must be equal. Per-example costs must agree
    # to rtol 1e-4 on at least 99% of the examples and to 1e-2 on all: an
    # example that is still iterating when lqr_iter ends (the pendulum
    # swing-ups) amplifies one-ulp differences -- a line-search step
    # accepted in one version and rejected in the other -- into another
    # path, a few per thousand by up to ~1e-3 (PERF.md).
    # x and u must agree to 1e-2 and 2e-2 on every example: at bang-bang
    # switching points u moves by about 1e-2 between two equally converged
    # optima (docs/DESIGN.md:103-107); the examples past the CPU tests'
    # 2e-3 are counted and printed.
    cases = [
        ("cartpole B=4096 T=20 eps=1e-4 (bench)", cp_dyn, cp_params, bench_cfg,
         cartpole_x0(4096), (torch.diag(cp_q), cp_p), None),
        ("pendulum B=1030 T=20 eps=0", pd_dyn, pd_params,
         cfg_for(pd_dyn, 3, T, 10, 0.0), pendulum_x0(1030),
         (torch.diag(pd_q), pd_p), None),
        ("pendulum B=1030 T=20 eps=1e-3", pd_dyn, pd_params,
         cfg_for(pd_dyn, 3, T, 10, 1e-3), pendulum_x0(1030),
         (torch.diag(pd_q), pd_p), None),
    ]
    scale = torch.linspace(0.5, 2.0, T, device=dev)[:, None]
    cases.append((
        "cartpole B=2048 T=20 warm start, per-time cost", cp_dyn, cp_params, bench_cfg,
        cartpole_x0(2048),
        (torch.diag_embed(scale * cp_q[None]), cp_p.expand(T, 6).contiguous()),
        (0.1 * torch.randn(T, 2048, 1, generator=gen)).to(dev),
    ))
    main_err = None
    for name, dyn, params, cfg, x0, cost_small, u0 in cases:
        lo, hi = dyn.lower, dyn.upper
        k_out = fused.ilqr_fused(cfg, dyn, params, x0, cost_small, u0, lo, hi)
        torch.cuda.synchronize()
        r_out = fused.ilqr_fused_reference(cfg, dyn, params, x0, cost_small, u0, lo, hi)
        torch.cuda.synchronize()
        kx, ku, kc, kdu, kn = k_out
        rx, ru, rc, rdu, rn = r_out
        if not (torch.isfinite(kc).all() and torch.isfinite(ku).all()):
            fail(f"{name}: non-finite kernel output")
        cost_rel = (kc - rc).abs() / rc.abs().clamp(min=1e-6)
        ex_u = (ku - ru).abs().amax(dim=(0, 2))
        ex_x = (kx - rx).abs().amax(dim=(0, 2))
        n_cost = int((cost_rel > 1e-4).sum())
        print(f"parity {name}: cost rel max {cost_rel.max().item():.2e} (past 1e-4: "
              f"{n_cost}/{x0.shape[0]}), u max {ex_u.max().item():.2e} (past 2e-3: "
              f"{int((ex_u > 2e-3).sum())}), x max {ex_x.max().item():.2e}, "
              f"n_iter {int(kn)} vs {int(rn)}", flush=True)
        if cost_rel.max().item() > 1e-2 or n_cost > 0.01 * x0.shape[0]:
            fail(f"{name}: costs disagree past their tolerance")
        if int(kn) != int(rn):
            fail(f"{name}: n_iter {int(kn)} (kernel) != {int(rn)} (plain)")
        if ex_x.max().item() > 1e-2 or ex_u.max().item() > 2e-2:
            fail(f"{name}: x or u past its bound (1e-2, 2e-2)")
        if main_err is None:
            main_err = max(ex_u.max().item(), ex_x.max().item())

    # ---- 4) the main path through its entry points ----
    for m in kernels.values():
        m.LAUNCHES = 0
    mpc = P.MPC(5, 1, T, u_lower=-100.0, u_upper=100.0, lqr_iter=20, eps=1e-4,
                linesearch_decay=0.5, max_linesearch_iter=2, backprop=False,
                exit_unconverged=False)
    cost = P.QuadCost(torch.diag(cp_q), cp_p)
    solves = {}
    for B in (4096, 16384):
        x0 = cartpole_x0(B)
        before = fused.LAUNCHES
        res = mpc.solve(x0, cost, cp_dyn, params=cp_params)
        torch.cuda.synchronize()
        if fused.LAUNCHES != before + 1:
            fail(f"MPC at B={B} did not go through the kernel")
        if res.x.shape != (B, T, 5) or res.u.shape != (B, T, 1):
            fail(f"MPC at B={B}: shapes {tuple(res.x.shape)}, {tuple(res.u.shape)}")
        if not (torch.isfinite(res.costs).all() and torch.isfinite(res.x).all()):
            fail(f"MPC at B={B}: non-finite output")
        if res.u.abs().max().item() > 100.0:
            fail(f"MPC at B={B}: controls outside the box")
        conv = res.converged.float().mean().item()
        solves[B] = (x0, res)
        print(f"main path MPC cartpole B={B}: n_iter {int(res.n_iter)}, mean cost "
              f"{res.costs.mean().item():.4f}, converged share {conv:.4f}", flush=True)
    before = fused.LAUNCHES
    ep = receding_horizon(bench_cfg, cp_dyn, cp_params, cost, cartpole_x0(1024), 5,
                          u_lower=cp_dyn.lower, u_upper=cp_dyn.upper)
    torch.cuda.synchronize()
    if fused.LAUNCHES - before != 5:
        fail(f"receding_horizon: {fused.LAUNCHES - before} launches for 5 steps")
    if ep.xs.shape != (1024, 6, 5) or not torch.isfinite(ep.xs).all():
        fail("receding_horizon: bad closed-loop states")
    launches = {name: m.LAUNCHES for name, m in kernels.items()}
    print(f"main path launches: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")

    # the kernel's answer on the main path, against its plain version
    x0, res = solves[4096]
    ref = fused.ilqr_fused_reference(bench_cfg, cp_dyn, cp_params, x0,
                                     (torch.diag(cp_q), cp_p), None, -100.0, 100.0)
    main_cost_rel = ((res.costs - ref[2]).abs() / ref[2].abs().clamp(min=1e-6)).max().item()
    print(f"main path B=4096 vs plain version: cost rel {main_cost_rel:.2e}", flush=True)
    if main_cost_rel > 1e-4:
        fail("main path costs disagree with the plain version")

    # ---- 5) times ----
    rows = []
    cs = (torch.diag(cp_q), cp_p)
    t_kernel = {}
    for B in (4096, 16384):
        x0 = cartpole_x0(B)
        ms, runs = cuda_ms(lambda: fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, x0, cs,
                                                    None, -100.0, 100.0), 2, 7)
        t_kernel[B] = ms
        out = fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, x0, cs, None, -100.0, 100.0)
        print(f"time ilqr_fused cartpole B={B} T={T}: {ms:.3f} ms median of {len(runs)} "
              f"({', '.join(f'{r:.3f}' for r in runs)}), {B / ms * 1e3:.0f} solves/s, "
              f"n_iter {int(out[4])} [{card}]", flush=True)
        t_e2e = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mpc.solve(x0, cost, cp_dyn, params=cp_params)
            torch.cuda.synchronize()
            t_e2e.append((time.perf_counter() - t1) * 1e3)
        e2e = statistics.median(t_e2e)
        print(f"time MPC.solve end to end B={B}: {e2e:.3f} ms median of 5 (host clock), "
              f"{B / e2e * 1e3:.0f} solves/s [{card}]", flush=True)
    # one 1024-example tile per SM: the batch at which every SM of an H100
    # holds exactly one block
    B_full = 132 * fused.TILE
    x0 = cartpole_x0(B_full)
    ms, runs = cuda_ms(lambda: fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, x0, cs,
                                                None, -100.0, 100.0), 1, 5)
    print(f"time ilqr_fused cartpole B={B_full} T={T}: {ms:.3f} ms median of {len(runs)}, "
          f"{B_full / ms * 1e3:.0f} solves/s [{card}]", flush=True)
    # closed loop: one receding-horizon step is one warm-started solve plus
    # the plant step and the plan shift
    x0 = cartpole_x0(1024)
    t_rh = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        receding_horizon(bench_cfg, cp_dyn, cp_params, cost, x0, 5,
                         u_lower=cp_dyn.lower, u_upper=cp_dyn.upper)
        torch.cuda.synchronize()
        t_rh.append((time.perf_counter() - t1) * 1e3 / 5)
    print(f"time receding_horizon cartpole B=1024: {statistics.median(t_rh):.3f} ms per step, "
          f"median of 3 episodes of 5 steps (host clock) [{card}]", flush=True)
    x0 = cartpole_x0(4096)
    plain_ms, runs = cuda_ms(lambda: fused.ilqr_fused_reference(
        bench_cfg, cp_dyn, cp_params, x0, cs, None, -100.0, 100.0), 1, 3)
    print(f"time ilqr_fused_reference (plain) cartpole B=4096: {plain_ms:.1f} ms "
          f"median of 3 [{card}]", flush=True)

    # bound: bench.py's FLOP model of the solve (per example, per step, per
    # iteration) times the iterations this run's tiles ran, over the
    # float32 peak; bytes: each input read once, each output written once
    out = fused.ilqr_fused(bench_cfg, cp_dyn, cp_params, x0, cs, None, -100.0, 100.0)
    nx, nu, B = 5, 1, 4096
    n = nx + nu
    step_f = 40.0
    per_t = (n * step_f + 2 * nx * nx * n + 2 * n * nx * n + 2 * n * nx + 10 + 250
             + 2 * (2 * nu * nx + 2 * n * n + step_f))
    tile_iters = _tile_iters(fused, bench_cfg, cp_dyn, cp_params, x0, cs)
    flops = per_t * T * sum(int(it) * min(fused.TILE, B - g * fused.TILE)
                            for g, it in enumerate(tile_iters))
    bytes_ = 4 * (B * nx + n * n + n + 4) + 4 * (T * B * n + 2 * B + len(tile_iters))
    bound_ms = max(flops / FP32_PEAK, bytes_ / HBM_RATE) * 1e3
    bound_by = "operations" if flops / FP32_PEAK >= bytes_ / HBM_RATE else "bytes"
    print(f"bound ilqr_fused B=4096: {flops:.3e} FLOP, {bytes_} bytes -> {bound_ms:.4f} ms "
          f"({bound_by}); tile iterations {tile_iters}; no single PyTorch call computes "
          f"an iLQR solve, so library_ms is null", flush=True)
    rows.append({
        "name": "ilqr_fused", "route": "cuda",
        "source": "dilqr_tpu_torch/csrc/ilqr_fused.cu",
        "replaces": "dilqr_tpu/ops/pallas/ilqr_fused.py:699",
        "launches": launches["ilqr_fused"], "max_abs_err": main_err,
        "ms": t_kernel[4096], "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    })
    del out
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


def _tile_iters(fused, cfg, dyn, params, x0, cs):
    """Iterations each 1024-example tile ran: one kernel launch per tile's
    own examples (tiles are independent, so this is the same count)."""
    its = []
    for g in range(0, x0.shape[0], fused.TILE):
        its.append(int(fused.ilqr_fused(cfg, dyn, params, x0[g:g + fused.TILE], cs,
                                        None, -100.0, 100.0)[4]))
    return its


if __name__ == "__main__":
    main()
