"""Program spans, stage marks and a structured metrics sink (port of
``epivo_tpu/utils/profiling.py``).

- :func:`span`: a named host range in a ``torch.profiler`` trace, open
  only while a profiler runs; otherwise one shared no-op, so the path
  costs one attribute read a span. No switch of its own: run the program
  under ``torch.profiler.profile`` and the spans are there, on the device
  trace's clock, each nested in the span that encloses it on its thread.
  :data:`SPAN_TOTALS` keeps each name's host seconds meanwhile.
- :func:`mark`: a one-thread kernel named after a stage of the VO step
  (``stage_mark_<stage>_kernel``, ``csrc/stage_mark.cu``), launched on
  the current stream by a step that runs the hand-written kernels, while
  it is captured into the step's CUDA graph or profiled, so a device
  trace splits a replay by stage from the kernel records alone.
- :class:`MetricsLogger`: per-window / per-batch records as JSONL.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from epivo_tpu_torch import _kernels
from epivo_tpu_torch._device import kernel_wanted

# The stages of the VO step in the order the step marks them; the index is
# the mark's number in ``csrc/stage_mark.cu``. "undistort" opens only a step
# given raw frames (``VOConfig.distortion``); "end" closes the step.
STAGES = ("undistort", "frontend", "estimate", "refine", "end")
_MARKS = {stage: (k, f"stage_mark_{stage}") for k, stage in enumerate(STAGES)}

# Host seconds and count of each span name, summed while a profiler runs:
# {name: [seconds, spans]}.
SPAN_TOTALS: dict[str, list] = {}

_OFF = contextlib.nullcontext()


class _Span:
    """An open span: a ``torch.profiler`` range whose concrete inputs are
    the span's ids (shown with ``record_shapes=True``), timed into
    :data:`SPAN_TOTALS`."""

    __slots__ = ("name", "ids", "handle", "t0")

    def __init__(self, name: str, ids: tuple):
        self.name, self.ids = name, ids

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.ids)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        torch.autograd._record_function_with_args_exit(self.handle)
        total = SPAN_TOTALS.setdefault(self.name, [0.0, 0])
        total[0] += dt
        total[1] += 1
        return False


def span(name: str, **ids):
    """A host span ``name`` carrying ``ids`` (integers: a call's seed, a
    batch's index and first frame) while a ``torch.profiler`` runs, else
    the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, tuple(ids.values()))


def span_totals() -> dict:
    """{span name: (host seconds, spans)} of the spans closed while a
    profiler ran, since the process began."""
    return {k: tuple(v) for k, v in SPAN_TOTALS.items()}


def mark(stage: str, like: torch.Tensor, use_kernel: bool | None = None) -> None:
    """Launch ``stage``'s mark kernel on the current stream of ``like``'s
    device where the step runs the hand-written kernels
    (``_device.kernel_wanted(like, use_kernel)``) and a CUDA graph is being
    captured or a profiler runs; nothing otherwise, so the plain route and
    an untraced eager step launch none."""
    if not kernel_wanted(like, use_kernel):
        return
    if _profiler._is_profiler_enabled or torch.cuda.is_current_stream_capturing():
        number, name = _MARKS[stage]
        _kernels.check(_kernels.lib().epivo_stage_mark(number, _kernels.stream_of(like)), name)


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
