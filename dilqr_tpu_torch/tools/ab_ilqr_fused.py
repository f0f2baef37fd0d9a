"""Time the whole-solve kernel of one checkout at chip_smoke.py's shapes, to
compare two checkouts on one card.

    python dilqr_tpu_torch/tools/ab_ilqr_fused.py --tree DIR

DIR is the root of a checkout of this repository (``.`` for this one): its
``dilqr_tpu_torch`` is imported and its kernel built. Prints one JSON line
with the card's name and power limit and, for each shape, the median and
the runs of CUDA-event-timed ``ilqr_fused`` calls after a warm-up, and the
solve's n_iter. The shapes are chip_smoke.py's: cartpole (bench.py's
configuration) at B=4096, 16384 and 135168, the rocket at B=1024, 16384
and 135168, with inputs from fixed seeds. Run it on two checkouts in turns
(A B B A) inside one session on the card: two sessions may get two cards.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    import dilqr_tpu_torch as P
    from dilqr_tpu_torch.models import cartpole, rocket
    from dilqr_tpu_torch.ops.cuda import ilqr_fused as fused

    if not torch.cuda.is_available():
        sys.exit("ab_ilqr_fused needs an NVIDIA GPU")
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            runs.append(a.elapsed_time(b))
        return statistics.median(runs), runs

    rows = {}
    cd, cp = cartpole.make(), cartpole.default_params(device=dev)
    cq, cpp = cartpole.get_true_obj(device=dev)
    ccfg = P.ILQRConfig(n_state=5, n_ctrl=1, T=20, lqr_iter=20, eps=1e-4, linesearch_decay=0.5,
                        max_linesearch_iter=2, exit_unconverged=False, detach_unconverged=False,
                        backprop=False)
    gen = torch.Generator(device="cpu").manual_seed(0)
    for B, reps in ((4096, 7), (16384, 7), (135168, 5)):
        th = math.pi / 1.05 + 0.1 * torch.randn(B, generator=gen)
        z = torch.zeros(B)
        x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1).to(dev)

        def solve():
            return fused.ilqr_fused(ccfg, cd, cp, x0, (torch.diag(cq), cpp), None, -100.0, 100.0)

        med, runs = ms(solve, reps)
        rows[f"cartpole B={B}"] = {"ms": med, "runs": runs, "n_iter": int(solve()[4])}
    rd, rp = rocket.make(), rocket.default_params(device=dev)
    rq, rpp = rocket.get_true_obj(device=dev)
    rcfg = P.ILQRConfig(n_state=13, n_ctrl=3, T=20, lqr_iter=15, eps=rd.mpc_eps,
                        linesearch_decay=rd.linesearch_decay,
                        max_linesearch_iter=rd.max_linesearch_iter, exit_unconverged=False,
                        detach_unconverged=True, backprop=False)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for B, reps in ((1024, 5), (16384, 5), (135168, 3)):
        x0 = rocket.bench_start(B, gen, device=dev)

        def solve():
            return fused.ilqr_fused(rcfg, rd, rp, x0, (torch.diag(rq), rpp), None, rd.lower,
                                    rd.upper)

        med, runs = ms(solve, reps)
        rows[f"rocket B={B}"] = {"ms": med, "runs": runs, "n_iter": int(solve()[4])}
    print(json.dumps({"tree": args.tree, "card": card, "times": rows}), flush=True)


if __name__ == "__main__":
    main()
