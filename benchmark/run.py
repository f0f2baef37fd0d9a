"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The cell (``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix, which ``benchmark/spec.py`` finds by name;
the traffic's mode names its runner (``benchmark/drive``). Set-up makes
every input on the card from the seed and warms the shapes the cell uses;
the runner then measures for ``--seconds``. With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, read on the host's clock; with ``--trace 1`` its
per-layer metrics, read from a torch.profiler window of at most
``TRACE_SECONDS`` and the program's counters, with the device's busy time
and the breakdown. Either way the sampled solves of the window are then held
against the plain reference (``check.py``), which decides ``correct``.

The last line of standard output is one JSON object. Exit codes: 0 with a
result; 2 where the card or the cells' files are missing; 3 where a module of
JAX or of the JAX package is loaded once the check is done.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TRACE_SECONDS = 5.0  # the longest traced window
FORBIDDEN = ("jax", "jaxlib", "flax", "dilqr_tpu")  # top-level module names


class Refused(Exception):
    """A run that must print no result: the exit code and why."""

    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


def quantity(metric: str) -> str:
    """What an end-to-end metric measures: its name up to the first dot.
    A suffix names a class of cells that holds the quantity to a bound of
    its own (``examples_per_s.host_paced``)."""
    return metric.split(".")[0]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader reads (``benchmark/metrics``)."""

    def __init__(self, outcome, busy_s, least_s):
        self.outcome = outcome
        self.busy_s = busy_s
        self.least_s = least_s


def _least_seconds(prob, samples):
    """(seconds, "operations" or "bytes"): the least time of one solve, the
    mean over the sampled solves, from the iterations the reference needs
    with each example stopping by its own rule (tile 1); (None, None)
    without samples."""
    from benchmark.work import ilqr as work

    least = []
    for s in samples:
        ref = prob.solve_reference(s["x_in"], s["u0"], tile=1)
        flops = work.solve_flops(prob.cfg, ref.iters, ref.trials)
        nbytes = work.solve_bytes(prob.cfg, s["x_in"].shape[0], s["u0"] is not None)
        least.append(work.least_seconds(flops, nbytes))
    if not least:
        return None, None
    return sum(t for t, _ in least) / len(least), least[0][1]


def run_cell(bench: dict, wl: dict, seed: int, seconds: float, tracing: bool, device: str,
             t_start: float, traffic_override=None, program=None) -> dict:
    """One run of the cell ``wl``; returns the result line's object.
    ``traffic_override`` replaces traffic parameters and ``program`` the
    program's (MPC, dynamics, cost), for the harness's own tests."""
    import torch

    from benchmark import check, spec
    from benchmark.measure import trace as tr
    from benchmark.problem import Problem

    prob = Problem(wl["config"], device)
    if program is not None:
        prob.program = program
    traffic = dict(spec.traffic(wl["traffic"]), **(traffic_override or {}))
    limits = spec.limits(wl["name"])
    runner = spec.runner(traffic["mode"])
    cuda = prob.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    window = min(seconds, TRACE_SECONDS) if tracing else seconds
    out = runner.run(prob, traffic, seed, window, tracing)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int(out.failed)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": wl["chips"], "memory_peak_bytes": int(peak)}
    metrics, breakdown, shown = {}, None, {}
    if not tracing:
        values = {"setup_s": out.t_start - t_start,
                  "examples_per_s": out.batch * out.solves / out.window_s}
        if len(out.step_ms) >= 2:
            values["step_ms_p95"] = statistics.quantiles(out.step_ms, n=100)[94]
        for m in spec.cell_metrics(bench, wl["name"], "end_to_end"):
            q = quantity(m["name"])
            if q not in values:
                raise Refused(2, f"the runner gives no {q}")
            metrics[m["name"]] = {"value": values[q], "unit": m["unit"]}
    else:
        busy = tr.busy_s(out.trace)
        least_s, shown["bound_by"] = _least_seconds(prob, out.samples)
        shown["least_ms"] = None if least_s is None else least_s * 1e3
        ctx = Context(out, busy, least_s)
        for m in spec.cell_metrics(bench, wl["name"], "per_layer"):
            v = spec.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = busy
        device_info["window_s"] = out.trace.window_s
        breakdown = tr.breakdown(out.trace)

    t_check = time.perf_counter()
    readings = [check.numbers(prob, s) for s in out.samples]
    values = check.worst(readings)
    correct, checks = check.judge(values, limits, failed)
    # last, after the reference, the readers and the check have loaded what
    # they load: the process that prints the result holds no JAX
    bad = forbidden_modules()
    if bad:
        raise Refused(3, f"modules loaded by the run: {', '.join(bad)}")
    result = {"correct": correct, "attempted": out.batch * out.solves, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = dict(checks, failed={"value": failed, "limit": 0})
    result["_shown"] = dict(shown, **{k: v for k, v in values.items() if k not in checks},
                            samples=len(readings), check_s=time.perf_counter() - t_check,
                            window_s=out.window_s, solves=out.solves)
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result line on standard output."""
    shown = result.pop("_shown", {})
    for k, v in shown.items():
        print(f"shown {k} {v!r}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from benchmark import spec

        bench = spec.benchmark()
        wl = spec.workload(bench, args.workload)
        import torch

        if not torch.cuda.is_available():
            raise Refused(2, "no CUDA card: the benchmark runs on the card only")
        if torch.cuda.device_count() < wl["chips"]:
            raise Refused(2, f"the cell asks for {wl['chips']} cards, "
                             f"{torch.cuda.device_count()} found")
        result = run_cell(bench, wl, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    except (FileNotFoundError, KeyError, ImportError) as e:
        print(f"benchmark: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
