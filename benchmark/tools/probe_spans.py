"""A probe of the program's spans in a closed-loop cell's traced window:
where a solve's host time goes, and how far the device's timestamps sit
from the host's clock.

    python3 benchmark/tools/probe_spans.py --workload cartpole.mpc_loop.b65536 \
        --seed 1 --seconds 5

Runs the cell's runner once, traced, as ``run.py --trace 1`` does (without
the check), and prints one JSON line: the card, the traced step's mean
(ms), the solves and the launches the program counted and the trace
recorded; the six span readers' numbers and ``off_kernel_ms``; the
device's idle seconds by the runner's span (``measure.trace.breakdown``); the
program's spans per solve (ms) and the rest of ``solve`` outside the four
inside it; the margins by which kernels seem to start before their launch
spans (``measure.program.margins``, us: least, median, largest, and the
medians of the window's first and last tenth of launches); the pairing's
start offsets less their median (quartiles, us) and the median end offset
less the median start offset (us: how much longer ``bench.solve`` is than
the program's ``solve``). Not a cell: the benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

READERS = ("solve_host_ms", "canonicalize_ms", "gate_ms", "prepare_ms", "launch_ms",
           "solve_idle_ms", "off_kernel_ms")
INNER = ("solve.canonicalize", "ilqr.gate", "ilqr_fused.prepare", "ilqr_fused.launch")


def spread(values):
    """(least, median, largest) and the quartiles, or None for no values."""
    if not values:
        return None
    q = statistics.quantiles(values, n=4) if len(values) >= 2 else [values[0]] * 3
    return {"least": min(values), "median": statistics.median(values), "largest": max(values),
            "quartiles": q}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec
    from benchmark.measure import program
    from benchmark.measure import trace as tr
    from benchmark.problem import Problem
    from benchmark.run import Context

    if not torch.cuda.is_available():
        print("probe_spans: no CUDA card", file=sys.stderr)
        return 2
    wl = spec.workload(spec.benchmark(), args.workload)
    traffic = spec.traffic(wl["traffic"])
    prob = Problem(wl["config"], "cuda")
    out = spec.runner(traffic["mode"]).run(prob, traffic, args.seed, args.seconds, True)
    ctx = Context(out, tr.busy_s(out.trace), None)
    line = {"workload": args.workload, "seed": args.seed,
            "device": torch.cuda.get_device_name(0),
            "step_ms_mean": statistics.fmean(out.step_ms), "solves": out.solves,
            "launches": out.launches,
            "kernels_recorded": sum(program.KERNEL in d.name for d in out.trace.device),
            "readings": {m: spec.metric_reader(m).read(ctx) for m in READERS},
            "idle_gaps": tr.breakdown(out.trace)["idle_gaps"]}
    placed = program.place(out.trace, program.log())
    if placed is not None:
        per = {}
        for sp in placed.spans:
            per[sp.name] = per.get(sp.name, 0.0) + (sp.end - sp.start) / 1e3 / placed.solves
        per["rest"] = per.get(program.SOLVE, 0.0) - sum(per.get(n, 0.0) for n in INNER)
        line["span_ms_per_solve"] = per
        mid = statistics.median(placed.offsets)
        line["pairing_us"] = spread([o - mid for o in placed.offsets])
        line["end_less_start_offset_us"] = statistics.median(placed.end_offsets) - mid
        m = program.margins(out.trace, placed, out.launches)
        if m is not None:
            tenth = max(1, len(m) // 10)
            line["margins_us"] = dict(spread(m), first_tenth=statistics.median(m[:tenth]),
                                      last_tenth=statistics.median(m[-tenth:]))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
