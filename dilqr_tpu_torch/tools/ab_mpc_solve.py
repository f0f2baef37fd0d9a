"""Time MPC.solve end to end (host clock, synchronized) in one checkout, to
compare two checkouts on one card.

    python dilqr_tpu_torch/tools/ab_mpc_solve.py --tree DIR [--reps 30]

DIR is the root of a checkout of this repository (``.`` for this one): its
``dilqr_tpu_torch`` is imported and its kernel built. Prints one JSON line
with the card's name and power limit and, for each batch, the median and
the runs of ``MPC.solve`` on chip_smoke.py's cartpole serving problem
(bench.py's configuration, backprop=False, box +-100) after a warm-up:
B=64 and 1024 (one tile: the host's share of a call is largest there) and
4096. The whole call is timed, the host work around the kernel included.
Run it on two checkouts in turns (A B B A) inside one session on the card:
two sessions may get two cards.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    import dilqr_tpu_torch as P
    from dilqr_tpu_torch.models import cartpole
    from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused

    if not torch.cuda.is_available():
        sys.exit("ab_mpc_solve needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    dyn, params = cartpole.make(), cartpole.default_params(device=dev)
    q, p = cartpole.get_true_obj(device=dev)
    cost = P.QuadCost(torch.diag(q), p)
    mpc = P.MPC(5, 1, 20, u_lower=-100.0, u_upper=100.0, lqr_iter=20, eps=1e-4,
                linesearch_decay=0.5, max_linesearch_iter=2, backprop=False,
                exit_unconverged=False)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = {}
    for B in (64, 1024, 4096):
        th = math.pi / 1.05 + 0.1 * torch.randn(B, generator=gen)
        z = torch.zeros(B)
        x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)
        before = fused.LAUNCHES
        mpc.solve(x0, cost, dyn, params=params)
        if fused.LAUNCHES != before + 1:
            sys.exit(f"ab_mpc_solve: MPC.solve at B={B} did not launch the kernel once")
        runs = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mpc.solve(x0, cost, dyn, params=params)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t1) * 1e3)
        rows[f"cartpole B={B}"] = {"ms": statistics.median(runs), "runs": runs}
    print(json.dumps({"tree": args.tree, "card": card, "times": rows}), flush=True)


if __name__ == "__main__":
    main()
