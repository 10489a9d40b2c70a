"""Stage timers, device traces and a structured metrics sink (port of
``epivo_tpu/utils/profiling.py``).

- :class:`StageTimer`: accumulating per-stage wall timers; with ``fence``
  each stage ends with ``torch.cuda.synchronize`` (the counterpart of
  ``jax.block_until_ready``), so a stage's time includes the device work
  it enqueued.
- :func:`device_trace`: a ``torch.profiler`` trace of the block, written as
  a Chrome trace (viewable in Perfetto).
- :class:`MetricsLogger`: per-window / per-batch records as JSONL.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import numpy as np
import torch


def _fence(result) -> None:
    """Wait for the device work behind ``result`` (a tensor, or a
    structure holding tensors) to finish."""
    if result is None:
        return
    leaves = result if isinstance(result, (tuple, list)) else [result]
    devices = {x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating per-stage wall timers with optional device fencing."""

    def __init__(self, fence: bool = True):
        self.fence = fence
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.fence:
                _fence(result)
            self._add(name, time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Run fn, fence its output, record the stage time, return output."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.fence:
            _fence(out)
        self._add(name, time.perf_counter() - t0)
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1000.0 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = []
        for k, v in self.summary().items():
            lines.append(
                f"{k:24s} {v['total_s']:8.3f} s  x{v['count']:<5d}"
                f" {v['mean_ms']:9.2f} ms/call"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(out_dir: str):
    """Trace the block with ``torch.profiler`` (host and, when a card is
    present, device activity) into ``out_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


class MetricsLogger:
    """Structured per-window/per-frame metrics -> JSONL."""

    def __init__(self, path: str | None):
        self.path = path
        self._f = open(path, "a") if path else None

    def log(self, record: dict[str, Any]) -> None:
        rec = {k: _jsonable(v) for k, v in record.items()}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def _jsonable(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v.item() if v.size == 1 else v.tolist()
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    return v
