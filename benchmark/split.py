"""Where a cell's traced call spends its time, by the program's own spans
and stage marks, and what the spans cost under the profiler.

    python3 -m benchmark.split --workload kitti00_vo.offline_b32 --seed 7 \\
        --seconds 8 --pairs 3 --out split.jsonl

Sets the cell up as a run does, measures a short untraced window (the
wall per call that idle is read against), then makes ``--pairs`` pairs of
traced calls through the cell's own ``traced()``: one with the program's
spans, one with ``profiling.span`` patched to the no-op, in turns (on,
off, off, on, ...). Each traced call prints one JSON line (and appends it
to ``--out``): the traced host wall, device busy time and activities a
call, the step's busy time by stage (``harness/program.py``), the idle
time under each innermost span, and, with spans, the runner's host time
from the span totals. A last untraced window times the same spans on the
host clock alone (no profiler) and prints their ms a call: the host's
wait in ``vo.fetch`` is read there, since under the profiler the graph
launch (``graph.replay``) absorbs it. A last window runs under a profiler
of host activities alone (no device tracing) and prints the program's
span totals a call, to see whether such a profiler leaves the wait where
the untraced run has it.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


class _Timed:
    """A span timed on the host clock alone, summed into ``totals``."""

    def __init__(self, totals: dict, name: str):
        self.totals, self.name = totals, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        total = self.totals.setdefault(self.name, [0.0, 0])
        total[0] += time.perf_counter() - self.t0
        total[1] += 1


def reading(t, dev: list, totals_before: dict, totals_after: dict, spans: bool) -> dict:
    """One traced call's line."""
    from benchmark.harness import program

    per_call = lambda s: 1e3 * s / t.calls
    idle = collections.defaultdict(float)
    for label, s in t.idle_gaps:
        idle[label] += s
    idle_s = sum(idle.values())
    out = {"spans": spans, "calls": t.calls, "traced_wall_ms": per_call(t.window_s),
           "busy_ms": t.busy_per_call_ms(), "activities": t.activities_per_call(),
           "idle_share_pct": t.idle_share_pct(), "traced_idle_ms": per_call(idle_s),
           "idle_by_span_pct": {k: 100.0 * v / idle_s for k, v in
                                sorted(idle.items(), key=lambda kv: -kv[1])} if idle_s else {},
           "longest_gaps": [[label, 1e3 * s] for label, s in t.idle_gaps[:10]]}
    stages = program.stage_busy_s(dev)
    if stages is not None:
        out["stage_ms"] = {k: per_call(v) for k, v in stages.items()}
        out["stage_sum_over_busy"] = sum(stages.values()) / t.busy_s
    zero = (0.0, 0)
    delta = {k: (s - totals_before.get(k, zero)[0], n - totals_before.get(k, zero)[1])
             for k, (s, n) in totals_after.items() if n > totals_before.get(k, zero)[1]}
    if "vo.sequence" in delta:
        out["runner_host_ms"] = per_call(program.runner_host_s(delta))
    if delta:
        out["span_ms"] = {k: per_call(s) for k, (s, _) in sorted(delta.items())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as cell_mod, program, spec as spec_mod, trace
    from epivo_tpu_torch import _graphs
    from epivo_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("benchmark.split: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec_mod.cell(args.workload)
    drv = cell_mod.driver(cell, args.seed, torch.device("cuda", 0))
    drv.setup()
    win = drv.window(args.seconds)
    kept = {}
    events = trace._events

    def keep(prof):
        kept["dev"], kept["host"] = events(prof)
        return kept["dev"], kept["host"]

    trace._events = keep
    span, off = profiling.span, lambda name, **ids: profiling._OFF

    def emit(line: dict) -> None:
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    emit({"workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(0),
          "wall_per_call_ms": 1e3 * win["wall_per_call_s"], "graph_build_s": program.build_s(),
          "build_totals": getattr(_graphs, "build_totals", dict)()})
    for k in range(args.pairs):
        for spans in ((True, False) if k % 2 == 0 else (False, True)):
            profiling.span = span if spans else off
            before = profiling.span_totals()
            t = drv.traced()
            t.wall_per_call_s = win["wall_per_call_s"]
            emit(reading(t, kept["dev"], before, profiling.span_totals(), spans))
    timed = {}
    profiling.span = lambda name, **ids: _Timed(timed, name)
    win = drv.window(args.seconds)
    profiling.span = span
    calls = win["note"].get("step_calls", win["note"].get("calls"))
    emit({"untraced": True, "calls": calls, "wall_per_call_ms": 1e3 * win["wall_per_call_s"],
          "span_ms": {k: 1e3 * s / calls for k, (s, _) in sorted(timed.items())}})
    before = profiling.span_totals()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        win = drv.window(args.seconds)
    zero = (0.0, 0)
    calls = win["note"].get("step_calls", win["note"].get("calls"))
    emit({"cpu_profiler": True, "calls": calls, "wall_per_call_ms": 1e3 * win["wall_per_call_s"],
          "span_ms": {k: 1e3 * (s - before.get(k, zero)[0]) / calls
                      for k, (s, _) in sorted(profiling.span_totals().items())
                      if s > before.get(k, zero)[0]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
