"""The traced run's reading of the card: torch.profiler over a short
steady stretch of calls, reduced to what the per-layer readers read.

The profiler nearly doubles a graph replay's host wall, so the idle share
is read against the untraced wall time per call of the same run's
measured window, never against the traced stretch.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import tempfile
import time

from benchmark.harness import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class TraceSummary:
    """What a traced stretch of ``calls`` calls showed."""

    calls: int  # calls of the cell's unit (a step, a window call) traced
    window_s: float  # host-clock length of the traced stretch
    busy_s: float  # time with an operation on the device (overlaps once)
    activities: int  # device activities (kernels, copies, sets)
    ops: dict  # device op name -> [seconds, count]
    idle_gaps: list  # [(label, seconds)], longest first
    wall_per_call_s: float | None = None  # untraced, from the measured window
    bounds: dict = dataclasses.field(default_factory=dict)  # kernel -> least s

    def busy_per_call_ms(self) -> float | None:
        return 1e3 * self.busy_s / self.calls if self.calls and self.busy_s > 0 else None

    def activities_per_call(self) -> float | None:
        return self.activities / self.calls if self.calls and self.activities else None

    def idle_share_pct(self) -> float | None:
        if not self.calls or not self.wall_per_call_s or self.busy_s <= 0:
            return None
        return stats.idle_share_pct(self.busy_s / self.calls, self.wall_per_call_s)

    def kernel_s(self, kernel: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``kernel``."""
        s = n = 0
        for name, (sec, count) in self.ops.items():
            if kernel in name:
                s, n = s + sec, n + count
        return s, n

    def roofline_pct(self, kernel: str, symbol: str) -> float | None:
        """The least time of the traced launches of ``kernel`` (its work
        at these inputs, ``bounds[kernel]``) over their device time, in
        percent; None where the trace holds no launch of ``symbol``."""
        sec, n = self.kernel_s(symbol)
        if not n or sec <= 0 or kernel not in self.bounds:
            return None
        return 100.0 * self.bounds[kernel] / sec

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[name, sec] for name, (sec, _) in top],
                "idle_gaps": [[label, sec] for label, sec in self.idle_gaps[:10]]}


def span(name: str):
    """A host span in the trace (a no-op cost outside the profiler)."""
    import torch

    return torch.profiler.record_function(name)


def _events(prof) -> tuple[list, list]:
    """(device activities [(name, start_us, end_us)], host spans [(name,
    start_us, end_us)]) of a finished profile, from its Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        rng = (ev.get("name", "?"), float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
        if cat in DEVICE_CATS:
            dev.append(rng)
        elif cat == "user_annotation":
            host.append(rng)
    return dev, host


def _label(t: float, host: list) -> str:
    """The innermost benchmark span open at time t, else 'host'."""
    best = None
    for name, s, e in host:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else "host"


def summarize(dev: list, host: list, calls: int, window_s: float) -> TraceSummary:
    """Reduce a traced stretch's device activities and host spans."""
    ops = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in dev:
        ops[name][0] += (e - s) * 1e-6
        ops[name][1] += 1
    iv = [(s, e) for _, s, e in dev]
    busy = stats.union_length(iv) * 1e-6
    idle = []
    if iv:
        lo = min(s for s, _ in iv)
        hi = max(e for _, e in iv)
        idle = sorted(((_label(s, host), (e - s) * 1e-6) for s, e in stats.gaps(iv, lo, hi)),
                      key=lambda g: -g[1])
    return TraceSummary(calls=calls, window_s=window_s, busy_s=busy, activities=len(dev),
                        ops=dict(ops), idle_gaps=idle)


def profile(fn, calls: int) -> TraceSummary:
    """Run ``fn`` (which makes ``calls`` calls) under torch.profiler with
    CPU and CUDA activities, after a synchronize, and summarize it."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = _events(prof)
    return summarize(dev, host, calls, window_s)
