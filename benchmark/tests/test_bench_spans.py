"""The program's spans on a traced window's clock (``measure/program.py``)
and the six readers of them, on a synthetic trace and log: the pairing of
program and runner solves, the skew check, and nothing read where the log,
the pairing or the launches fall short."""
from __future__ import annotations

import collections
import json
import os

import pytest

from cpu_cells import ROOT

from benchmark import spec
from benchmark.measure import program
from benchmark.measure import trace as tr

T0 = 1_760_000_000_000_000_000  # ns on the host's clock at the trace's start
STEP = 2000.0  # us between the runner's solves
LAG = 10.0  # us from the runner's bench.solve to the program's solve
READERS = ("solve_host_ms", "canonicalize_ms", "gate_ms", "prepare_ms", "launch_ms",
           "solve_idle_ms")
# each program span of a solve, us after the runner's bench.solve starts
PARTS = (("solve.canonicalize", 10, 60), ("ilqr.gate", 60, 80),
         ("ilqr_fused.prepare", 80, 300), ("ilqr_fused.launch", 300, 320), ("solve", 10, 700))


def _ns(us):
    return T0 + round(us * 1e3)


def _window(n=4, kernel_after=30.0, older=0):
    """A trace of n loop steps and the program's log: ``older`` solves of an
    earlier window first; each kernel starts ``kernel_after`` us after its
    launch span does (true times) and runs to 1500 us into the step; one
    small device op at 50-60 us."""
    spans, device, log = [], [], []
    for k in range(-older, n):
        b = 1000.0 + k * STEP
        for name, s, t in PARTS:
            log.append((name, _ns(b + s), _ns(b + t)))
        if k < 0:
            continue
        spans.append(tr.Interval("solve", b, b + 900))
        spans.append(tr.Interval("sync", b + 900, b + 1600))
        device.append(tr.Interval("elementwise", b + 50, b + 60))
        device.append(tr.Interval("void dilqr::ilqr_fused_kernel<...>", b + 300 + kernel_after,
                                  b + 1500))
    # the log is in the order spans end: the solve after its inner spans
    log.sort(key=lambda e: e[2])
    return tr.Trace(device, spans, 0.0, 1000.0 + n * STEP), log


class _Out:
    def __init__(self, trace, launches):
        self.trace, self.launches = trace, launches


class _Ctx:
    def __init__(self, trace, launches):
        self.outcome = _Out(trace, launches)


def _read(monkeypatch, trace, log, launches):
    monkeypatch.setattr(program, "log", lambda: log)
    ctx = _Ctx(trace, launches)
    return {m: spec.metric_reader(m).read(ctx) for m in READERS}


def test_place_pairs_the_windows_solves_by_their_starts():
    trace, log = _window(n=4, older=3)
    placed = program.place(trace, log)
    assert placed.solves == 4
    # one offset for every pair; bench.solve outlasts the program's solve by
    # its 900 us less 690
    assert max(placed.offsets) - min(placed.offsets) == pytest.approx(0.0, abs=1e-6)
    assert [e - s for s, e in zip(placed.offsets, placed.end_offsets)] == pytest.approx(
        [210.0] * 4)
    # the median start offset moves each program span LAG early
    solves = [sp for sp in placed.spans if sp.name == "solve"]
    assert [sp.start for sp in solves] == pytest.approx([1000.0 + k * STEP for k in range(4)])
    assert len(placed.spans) == 4 * len(PARTS)  # the earlier window's spans are left out
    m = program.margins(trace, placed, 4)
    assert m == pytest.approx([-30.0 - LAG] * 4)


def test_the_six_readers_split_the_solve(monkeypatch):
    trace, log = _window(n=4, older=2)
    got = _read(monkeypatch, trace, log, 4)
    assert got["solve_host_ms"] == pytest.approx(0.690)
    assert got["canonicalize_ms"] == pytest.approx(0.050)
    assert got["gate_ms"] == pytest.approx(0.020)
    assert got["prepare_ms"] == pytest.approx(0.220)
    assert got["launch_ms"] == pytest.approx(0.020)
    # the placed solve [0, 690] us less the op's 10 and the kernel's [330, 690]
    assert got["solve_idle_ms"] == pytest.approx((690 - 10 - 360) / 1e3)
    inner = sum(got[m] for m in ("canonicalize_ms", "gate_ms", "prepare_ms", "launch_ms"))
    assert inner <= got["solve_host_ms"] and got["solve_idle_ms"] <= got["solve_host_ms"]


def test_a_skew_over_the_limit_leaves_the_idle_time_unread(monkeypatch):
    # kernels that seem to start 5 us before their launch span read a margin
    # of -5 us (the spans placed LAG early) and pass; 55 us before, 45 us,
    # over the limit, do not
    trace, log = _window(kernel_after=-5.0)
    assert max(program.margins(trace, program.place(trace, log), 4)) == pytest.approx(
        5.0 - LAG)
    assert _read(monkeypatch, trace, log, 4)["solve_idle_ms"] is not None
    trace, log = _window(kernel_after=-25.0 - LAG - program.SKEW_LIMIT_US)
    m = program.margins(trace, program.place(trace, log), 4)
    assert max(m) > program.SKEW_LIMIT_US
    got = _read(monkeypatch, trace, log, 4)
    assert got["solve_idle_ms"] is None
    assert got["solve_host_ms"] == pytest.approx(0.690)  # the host's side still reads


@pytest.mark.parametrize("fault", ["no log", "fewer program solves", "no runner solves",
                                   "a launch the trace lost", "a launch more than counted"])
def test_nothing_read_where_the_counts_do_not_match(monkeypatch, fault):
    trace, log = _window(n=4)
    launches = 4
    if fault == "no log":
        log = None
    elif fault == "fewer program solves":
        log = [e for e in log if not (e[0] == "solve" and e[1] == min(
            s for n, s, _ in log if n == "solve"))]
    elif fault == "no runner solves":
        trace = trace._replace(spans=[sp for sp in trace.spans if sp.name != "solve"])
    elif fault == "a launch the trace lost":
        launches = 5
    else:
        launches = 3
    got = _read(monkeypatch, trace, log, launches)
    assert got["solve_idle_ms"] is None
    if fault.startswith("a launch"):
        assert got["launch_ms"] == pytest.approx(0.020)
    else:
        assert all(v is None for v in got.values()), got


def test_the_log_of_a_program_without_spans_is_none(monkeypatch):
    from dilqr_tpu_torch.utils import profiling

    assert isinstance(program.log(), list)
    monkeypatch.delattr(profiling, "span_log")
    assert program.log() is None
    trace, _ = _window()
    assert all(spec.metric_reader(m).read(_Ctx(trace, 4)) is None for m in READERS)


def test_the_trace_keeps_only_the_runners_spans(monkeypatch):
    """``measure.trace.read`` keeps the ``bench.*`` ranges and no program
    span, so the breakdown splits idle time as it did before the program
    had spans."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from dilqr_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_SPAN_LOG", collections.deque())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            with tr.span("solve", True):
                with profiling.span("solve"):
                    pass
    got = tr.read(prof)
    assert [sp.name for sp in got.spans] == ["solve"] and got.device == []


def test_the_six_entries_of_benchmark_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    mine = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert set(mine) == set(READERS)
    for m in mine.values():
        assert m == dict(name=m["name"], unit="ms", better="lower", source="program_span",
                         layer="solver host path", moves="step_ms_p95",
                         workloads=["cartpole.mpc_loop.b65536", "rocket.mpc_loop.b16384"])


def test_an_untraced_run_leaves_the_span_log_empty(monkeypatch):
    """The benchmark's untraced runs pay for no span: a small CPU run of a
    loop cell logs nothing."""
    from cpu_cells import run_small

    from dilqr_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_SPAN_LOG", collections.deque())
    res = run_small("cartpole.mpc_loop.b65536")
    assert res["correct"] and profiling.span_log() == []
