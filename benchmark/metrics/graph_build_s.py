"""Host seconds the graph cache spent building since the process began:
its eager first calls plus its captures (warm-up, recording and
instantiation), from the program's ``_graphs.build_totals()``, read after
the traced stretch. The totals leave out the kernel library's compile,
which only a checkout without the built library pays. None where the
program keeps no such totals."""

from benchmark.harness import program


def read(t):
    return program.build_s()
