"""canonicalize_ms: the host ms a solve of the traced window spends in the
program's ``solve.canonicalize`` span (``core/solver.solve`` up to the call
of ``solve_with_grad``: validation, casts, the ``canonicalize_*`` calls,
the slew-rate rewrite). Nothing is read without the program's spans."""

from benchmark.measure import program


def read(ctx):
    return program.host_ms(ctx, "solve.canonicalize")
