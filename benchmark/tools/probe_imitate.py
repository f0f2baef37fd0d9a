"""A probe of the training cell the benchmark leaves out,
``cartpole.imitate.b<B>``: full-batch imempc through ``ILExp.train_step``
(learn_cost and learn_dx, RMSprop 1e-2 / 0.5, the IFT backward, the
per-example warm-start store), on the card. It reads whether the card
carries the step: the device's idle share over a traced window of steady
steps, after a warm-up, and the step times before it.

    python3 benchmark/tools/probe_imitate.py --batch 262144 --seed 1 \
        --warm 15 --steps 20 --traced 20

Set-up: the expert (the cartpole at its true params, lqr_iter 50, T=20)
solves B starts drawn on the card from the seed by the cartpole
configuration's distribution; the learner starts from il_exp's
mis-specified dynamics and a zero cost, at lqr_iter 10. Then ``--warm``
steps, ``--steps`` steps each timed on the host's clock with a synchronize,
and ``--traced`` steps in one profiler window. One JSON line. Not a cell:
no reference and no ``correct``; the benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

EXPERT_ITERS, LEARNER_ITERS, HORIZON = 50, 10, 20  # data/cartpole.npz, il_exp.py


def build(batch: int, seed: int, device: str):
    """(ILExp, xinits, xs, us) with the expert's demonstrations."""
    import torch

    from benchmark.problem import Problem
    from dilqr_tpu_torch.il.env import ILEnv
    from dilqr_tpu_torch.il.exp import ILExp

    prob = Problem("cartpole", device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    xinits = prob.start(gen, batch)
    env = ILEnv("cartpole", lqr_iter=LEARNER_ITERS, mpc_T=HORIZON, device=device)
    with torch.no_grad():
        xs, us = env.mpc(env.true_params, xinits, env.true_q, env.true_p,
                         lqr_iter_override=EXPERT_ITERS, backprop=False)
    work = os.path.join(os.environ.get("TMPDIR") or tempfile.gettempdir(), "probe_imitate")
    exp = ILExp(env, mode="imempc", learn_cost=True, learn_dx=True, n_batch=batch,
                n_train=batch, seed=seed, work=work)
    return exp, xinits, xs, us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--warm", type=int, default=15)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--traced", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("probe: no CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    exp, xinits, xs, us = build(args.batch, args.seed, args.device)
    from dilqr_tpu_torch.ops.cuda import ilqr_fused, kkt_fused

    st = {"params": exp.params, "opt": exp.opt_state, "ws": torch.zeros_like(us), "k": 0}

    def step():
        # full batch: a step is an epoch, so the cost's round robin turns
        # every 10 steps and the warm starts are reset every 50 (ILExp.run)
        k = st["k"]
        if k % 50 == 0:
            st["ws"] = torch.zeros_like(us)
        st["params"], st["opt"], losses, ws = exp.train_step(
            st["params"], st["opt"], xinits, xs, us, st["ws"], (k // 10) % 2 == 1)
        st["ws"], st["k"] = ws, k + 1
        return losses

    def sync():
        if cuda:
            torch.cuda.synchronize()

    warm_ms = []
    for _ in range(args.warm):
        t = time.perf_counter()
        step()
        sync()
        warm_ms.append((time.perf_counter() - t) * 1e3)
    setup_s = time.perf_counter() - t0
    step_ms = []
    for _ in range(args.steps):
        t = time.perf_counter()
        losses = step()
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
    out = {"batch": args.batch, "seed": args.seed, "setup_s": setup_s, "warm_ms": warm_ms,
           "step_ms": step_ms, "step_ms_mean": statistics.fmean(step_ms),
           "im_loss": float(losses["im_loss"])}
    if cuda and args.traced:
        from benchmark.measure import trace as tr

        n1, n2 = ilqr_fused.LAUNCHES, kkt_fused.LAUNCHES
        t = time.perf_counter()
        with tr.window() as prof:
            for _ in range(args.traced):
                with tr.span("train_step", True):
                    step()
        traced_s = time.perf_counter() - t
        trace = tr.read(prof)
        busy = tr.busy_s(trace)
        out.update(traced_steps=args.traced, traced_step_ms=traced_s * 1e3 / args.traced,
                   busy_s=busy, window_s=trace.window_s, idle_share=1.0 - busy / trace.window_s,
                   device_ops_per_step=len(trace.device) / args.traced,
                   ilqr_launches_per_step=(ilqr_fused.LAUNCHES - n1) / args.traced,
                   kkt_launches_per_step=(kkt_fused.LAUNCHES - n2) / args.traced,
                   breakdown=tr.breakdown(trace),
                   kind=torch.cuda.get_device_name(0),
                   memory_peak_bytes=torch.cuda.max_memory_allocated())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
