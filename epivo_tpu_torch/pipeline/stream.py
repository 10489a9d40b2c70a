"""Bounded frame streaming + dispatch/fetch overlap for the sequence
runners (port of ``epivo_tpu/pipeline/stream.py``, plain numpy and Python,
copied).

- :class:`FrameStream`: random access over a forward-only frame iterator
  with an explicitly evicted bounded buffer, so a long sequence never
  materializes in host memory.
- :class:`PipelinedDispatch`: bounded-depth dispatch/fetch pipelining. A
  dispatch enqueues a batch's kernel launches on the device and returns at
  once; the fetch (``.cpu()`` of the batch's results) is the sync point.
  Dispatching batches k+1..k+depth (host: frame upload and the launches
  themselves) before fetching batch k overlaps host work with device
  compute, the role of the reference's producer thread
  (`kitti_ba.cpp:1118-1163`).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable

import numpy as np


class FrameStream:
    """Random access into a frame source with bounded memory.

    ``source`` may be a sequence (free random access, nothing is buffered)
    or a forward-only iterable (frames are pulled on demand, held in a
    dict buffer, and dropped by :meth:`evict_below`). Iterator sources
    only support non-decreasing access patterns between evictions.

    ``n_frames`` bounds the logical length when the source has no
    ``len()``; for sized sources it caps it.
    """

    def __init__(self, source: Iterable, n_frames: int | None = None):
        self._seq = None
        self._it = None
        if hasattr(source, "__getitem__") and hasattr(source, "__len__"):
            self._seq = source
            n = len(source)
            self._n = min(n, n_frames) if n_frames is not None else n
        else:
            self._it = iter(source)
            self._buf: dict[int, np.ndarray] = {}
            self._next = 0
            self._evicted = -1
            self._n = n_frames
            self.peak_buffered = 0

    def __len__(self) -> int:
        if self._n is None:
            raise TypeError(
                "frame stream has no known length; pass n_frames= (or a "
                "sized sequence)"
            )
        return self._n

    @property
    def sized(self) -> bool:
        return self._n is not None

    def get(self, i: int) -> np.ndarray:
        """Frame i as float32 (iterator sources: must not be evicted)."""
        if self._seq is not None:
            return np.asarray(self._seq[i], np.float32)
        if i <= self._evicted:
            raise IndexError(f"frame {i} was evicted (watermark "
                             f"{self._evicted}); access must be ordered")
        while self._next <= i:
            try:
                frame = next(self._it)
            except StopIteration:
                raise IndexError(
                    f"frame stream ended at {self._next}, requested {i}"
                ) from None
            # Frames at or below the eviction watermark are skipped, not
            # buffered (resume paths fast-forward without holding memory).
            if self._next > self._evicted:
                self._buf[self._next] = np.asarray(frame, np.float32)
            self._next += 1
        self.peak_buffered = max(self.peak_buffered, len(self._buf))
        return self._buf[i]

    def evict_below(self, i: int) -> None:
        """Drop buffered frames with index < i (no-op for sequences)."""
        if self._seq is not None:
            return
        for k in list(self._buf):
            if k < i:
                del self._buf[k]
        self._evicted = max(self._evicted, i - 1)

    def materialize(self) -> list[np.ndarray]:
        """Consume everything into a list (legacy unsized-iterator path)."""
        if self._seq is not None:
            return [np.asarray(self._seq[k], np.float32)
                    for k in range(len(self))]
        out = list(self._buf.values())
        out.extend(np.asarray(f, np.float32) for f in self._it)
        if self._n is not None:
            out = out[: self._n]
        else:
            self._n = len(out)
        self._seq = out
        self._it = None
        return out


class PipelinedDispatch:
    """Bounded-depth async dispatch pipeline.

    ``submit(dispatch_fn, fetch_ctx)`` calls ``dispatch_fn()`` immediately
    (enqueueing device work, which returns without blocking); once more than
    ``depth`` submissions are in flight, the OLDEST one's outputs are
    fetched and handed to ``on_ready(result, ctx)`` — in submission order.
    ``flush()`` drains everything still pending. With ``depth=1`` the
    device computes batch k while the host decodes/uploads batch k+1; with
    ``depth=d`` up to d batches are enqueued ahead of the fetch frontier.

    Host memory/device-queue cost is O(depth) pending result buffers, so
    keep depth small (2-4) — beyond the link's latency-bandwidth product
    there is no further win.
    """

    def __init__(self, on_ready: Callable, depth: int = 1):
        assert depth >= 1, depth
        self._on_ready = on_ready
        self._depth = depth
        self._pending: deque = deque()

    def submit(self, dispatch_fn: Callable, ctx) -> None:
        self._pending.append((dispatch_fn(), ctx))
        while len(self._pending) > self._depth:
            self._on_ready(*self._pending.popleft())

    def flush(self) -> None:
        while self._pending:
            self._on_ready(*self._pending.popleft())
