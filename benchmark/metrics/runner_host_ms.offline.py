"""Host ms per step call of the traced runner call's own work: the time
inside ``vo.sequence`` not covered by its ``vo.fetch`` and ``graph.*``
spans (stacking, uploads, dispatch, bookkeeping, the cloud, the finish),
from the program's span totals; None where the program keeps no such
spans."""

from benchmark.harness import program


def read(t):
    totals = program.span_totals()
    if not totals or "vo.sequence" not in totals or not t.calls:
        return None
    return 1e3 * program.runner_host_s(totals) / t.calls
