"""The solve path's spans (``utils/profiling.span``) on the CPU: nothing
without a profiler session, the nested ranges and their log entries under
one, the log's bound and ``span_totals``.

Tolerance: a log entry is stamped inside its range, so its start and end
lie within the cost of entering and leaving the range (a few microseconds;
20 allowed) of the profiler's own timestamps for it."""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import dilqr_tpu_torch as P
from dilqr_tpu_torch.models import cartpole
from dilqr_tpu_torch.utils import profiling

MATCH_US = 20.0


def _problem(B=8, T=6):
    dyn, params = cartpole.make(), cartpole.default_params()
    q, p = cartpole.get_true_obj()
    th = 3.0 + 0.1 * torch.randn(B, generator=torch.Generator().manual_seed(3))
    z = torch.zeros(B)
    x0 = torch.stack([z, z, th.cos(), th.sin(), z], 1)
    mpc = P.MPC(5, 1, T, u_lower=-100.0, u_upper=100.0, lqr_iter=2, eps=1e-4,
                exit_unconverged=False, backprop=False)
    return lambda: mpc.solve(x0, P.QuadCost(torch.diag(q), p), dyn, params=params)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def fresh_log(monkeypatch):
    """An empty span log for the test, the process's own left as it was."""
    monkeypatch.setattr(profiling, "_SPAN_LOG",
                        collections.deque(maxlen=profiling.SPAN_LOG_LEN))


def test_without_a_profiler_a_span_is_one_shared_object_and_logs_nothing(monkeypatch,
                                                                         fresh_log):
    solve = _problem()

    def no_range(name):
        raise AssertionError("a span opened a range with no profiler session")

    monkeypatch.setattr(profiling, "_RANGE", no_range)
    a, b = profiling.span("solve"), profiling.span("ilqr.gate")
    assert a is b is profiling._NO_SPAN
    with a as inside:
        assert inside is None
    res = solve()
    assert torch.isfinite(res.costs).all()
    assert profiling.span_log() == [] and profiling.span_totals() == {}


def _nested(log):
    """Each entry of ``log`` with the entries that lie inside it."""
    return {e: [f for f in log if f is not e and e[1] <= f[1] and f[2] <= e[2]] for e in log}


def test_solve_logs_nested_spans_that_match_the_profilers_ranges(fresh_log):
    """One MPC.solve under the profiler: ``solve`` holds
    ``solve.canonicalize`` then ``ilqr.gate``, and each entry matches the
    profiler's ``dilqr.*`` range for it. The session's first range costs the
    profiler a millisecond to open, so a warm-up solve goes first; a
    session whose stamps a descheduled thread pushed apart is opened again,
    up to three in all."""
    solve = _problem()
    for _ in range(3):
        with _cpu_profile() as prof:
            solve()
            solve()
        log = profiling.span_log()[-3:]  # the second solve's
        assert [e[0] for e in log] == ["solve.canonicalize", "ilqr.gate", "solve"]
        canon, gate, whole = log
        assert [f[0] for f in _nested(log)[whole]] == ["solve.canonicalize", "ilqr.gate"]
        assert canon[2] <= gate[1]
        # microseconds from the trace's start, the profiler's time_range
        t0 = prof.profiler.kineto_results.trace_start_ns()
        ranges = collections.defaultdict(list)
        for ev in prof.events():
            if ev.name.startswith(profiling.SPAN_PREFIX):
                ranges[ev.name[len(profiling.SPAN_PREFIX):]].append(
                    (ev.time_range.start, ev.time_range.end))
        assert {k: len(v) for k, v in ranges.items()} == {
            "solve": 2, "solve.canonicalize": 2, "ilqr.gate": 2}
        # the second solve's ranges are the later ones
        gaps = [max(abs(s - (start - t0) / 1e3), abs(t - (end - t0) / 1e3))
                for name, start, end in log for s, t in [max(ranges[name])]]
        if max(gaps) <= MATCH_US:
            break
    assert max(gaps) <= MATCH_US, gaps


def test_span_log_keeps_its_newest_entries_within_its_bound(monkeypatch):
    assert profiling._SPAN_LOG.maxlen == profiling.SPAN_LOG_LEN == 2 ** 17
    monkeypatch.setattr(profiling, "_SPAN_LOG", collections.deque(maxlen=8))
    with _cpu_profile():
        for i in range(20):
            with profiling.span(f"s{i}"):
                pass
    log = profiling.span_log()
    assert [e[0] for e in log] == [f"s{i}" for i in range(12, 20)]
    assert all(start <= end for _, start, end in log)


def test_span_totals_add_up(fresh_log):
    solve = _problem()
    with _cpu_profile():
        for _ in range(3):
            solve()
    log = profiling.span_log()
    totals = profiling.span_totals()
    assert set(totals) == {"solve", "solve.canonicalize", "ilqr.gate"}
    for name, (count, ms) in totals.items():
        mine = [(e - s) / 1e6 for n, s, e in log if n == name]
        assert count == len(mine) == 3
        assert ms == pytest.approx(sum(mine), rel=1e-12)
    assert totals["solve.canonicalize"][1] + totals["ilqr.gate"][1] <= totals["solve"][1]
