"""solve_idle_ms: the device's idle ms per solve inside the program's
``solve`` spans of the traced window: each span's time less its overlap
with the union of the device's intervals (``measure.trace.merged``), the
spans placed on the trace's clock by ``measure.program.place``. Nothing is
read without the program's spans, where the trace does not hold every
launch, or where the window's skew is over ``program.SKEW_LIMIT_US``
(``measure.program.checked``)."""

from benchmark.measure import program


def read(ctx):
    placed = program.checked(ctx)
    if placed is None:
        return None
    solves = [sp for sp in placed.spans if sp.name == program.SOLVE]
    return program.idle_within(solves, ctx.outcome.trace.device) / placed.solves / 1e3
