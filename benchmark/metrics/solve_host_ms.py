"""solve_host_ms: the mean host ms of the program's ``solve`` span
(``core/solver.solve``, the whole call) over the traced window's solves.
Nothing is read where the program logs no spans (``measure.program``)."""

from benchmark.measure import program


def read(ctx):
    return program.host_ms(ctx, "solve")
