"""The readings the limits of ``check.py`` are set from, on the card, at the
cell's own size: for each seed, the numbers of the program's sampled solves
in a short window of the cell's traffic; for each control seed, the same
sampled inputs solved by the reference in TF32 in the program's place
(``check.control``), judged by the same numbers. One JSON line a reading.

    python3 benchmark/calibrate.py --workload <name> --seconds 2 \
        --seeds 1,2,3 --control-seeds 4,5,6

Not run by the benchmark's own runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(wl: dict, seed: int, seconds: float, with_control: bool, device: str = "cuda",
             traffic_override=None):
    """[(kind, numbers)] of the cell's sampled solves for one seed."""
    from benchmark import check, spec
    from benchmark.problem import Problem

    prob = Problem(wl["config"], device)
    traffic = dict(spec.traffic(wl["traffic"]), **(traffic_override or {}))
    out = spec.runner(traffic["mode"]).run(prob, traffic, seed, seconds, False)
    rows = []
    for s in out.samples:
        rows.append(("program", check.numbers(prob, s)))
        if with_control:
            rows.append(("control", check.numbers(prob, check.control(prob, s))))
    return rows, int(out.failed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    wl = spec.workload(spec.benchmark(), args.workload)
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, ctl in plan:
        rows, failed = readings(wl, seed, args.seconds, ctl)
        for kind, nums in rows:
            print(json.dumps({"workload": wl["name"], "seed": seed, "kind": kind,
                              "failed": failed, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
