"""What the benchmark reads of the program's own instrumentation
(``epivo_tpu_torch/utils/profiling.py``, ``epivo_tpu_torch/_graphs.py``):
the host totals of its spans, the graph cache's build totals, and the
step's stage marks in a device trace. Each reader returns None where the
program lacks the instrumentation. The port is imported inside the
functions, as in ``port.py``.

Stage marks: the step launches ``stage_mark_<stage>_kernel`` for
``frontend``, ``estimate``, ``refine`` and ``end``. A device activity
belongs to the stage of the last mark that started before it (a mark to
the stage it opens); activities before the first mark, and from an
``end`` mark to the next ``frontend`` mark, belong to ``dispatch``:
uploads, draws, input copies, clones, packing and fetch copies. A
stage's time is the union of its activities' intervals.
"""

from __future__ import annotations

from benchmark.harness import stats

MARK = "stage_mark_"
STAGES = ("frontend", "estimate", "refine", "dispatch")


def span_totals() -> dict | None:
    """{span name: (host seconds, spans)} the program summed while a
    profiler ran, or None."""
    from epivo_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    return None if totals is None else totals()


def runner_host_s(totals: dict) -> float:
    """Host seconds inside ``vo.sequence`` not covered by its ``vo.fetch``
    and ``graph.*`` spans. The runner opens neither inside the other, and
    the cache opens one ``graph.*`` span at a time, so their totals add."""
    covered = sum(s for name, (s, _) in totals.items()
                  if name == "vo.fetch" or name.startswith("graph."))
    return totals["vo.sequence"][0] - covered


def build_s() -> float | None:
    """Host seconds of the graph cache's eager first calls and captures
    since the process began, less the kernel library's compile, or None."""
    from epivo_tpu_torch import _graphs

    totals = getattr(_graphs, "build_totals", None)
    if totals is None:
        return None
    built = totals()
    return built["eager_s"] + built["capture_s"]


def _stage(name: str, current: str) -> str:
    """The stage a device activity named ``name`` opens, else ``current``."""
    i = name.find(MARK)
    if i < 0:
        return current
    stage = name[i + len(MARK):].split("_kernel", 1)[0]
    return "dispatch" if stage == "end" else stage


def stage_busy_s(dev: list) -> dict | None:
    """{stage: busy seconds} of device activities [(name, start, end)] in
    microseconds, over ``STAGES``; None where no activity is a mark."""
    if not any(MARK in name for name, _, _ in dev):
        return None
    spans = {s: [] for s in STAGES}
    current = "dispatch"
    for name, s, e in sorted(dev, key=lambda a: (a[1], a[2])):
        current = _stage(name, current)
        spans[current].append((s, e))
    return {k: stats.union_length(iv) * 1e-6 for k, iv in spans.items()}
