"""Bounded frame streaming + dispatch/fetch overlap for the sequence
runners (port of ``epivo_tpu/pipeline/stream.py``, plain numpy and Python,
copied).

- :class:`FrameStream`: random access over a forward-only frame iterator
  with an explicitly evicted bounded buffer, so a long sequence never
  materializes in host memory.
- :class:`PipelinedDispatch`: bounded-depth dispatch/fetch pipelining. A
  dispatch enqueues a batch's kernel launches on the device and returns at
  once; the fetch of the batch's results is the sync point.
  Dispatching batches k+1..k+depth (host: frame upload and the launches
  themselves) before fetching batch k overlaps host work with device
  compute, the role of the reference's producer thread
  (`kitti_ba.cpp:1118-1163`).
- :class:`TransferRing` (the port's own): the host<->device transfers of
  the batches in flight, through reused (on the card pinned) host slots.
  A batch's fetch waits on an event of its own result copy, so the
  batches dispatched after it stay queued on the device.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable

import numpy as np
import torch


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


@dataclasses.dataclass
class _Slot:
    """One batch's transfer slot: flat host buffers for its frames and its
    result, the two events that guard them, and whether the batch staged
    in it still waits for its fetch."""

    frames: torch.Tensor | None = None
    result: torch.Tensor | None = None
    frames_shape: tuple = ()
    result_shape: tuple = ()
    uploaded: Any = None  # "upload done"
    copied: Any = None  # "result copied"
    busy: bool = False


class TransferRing:
    """Reused host<->device transfer slots for the batches that a
    :class:`PipelinedDispatch` keeps in flight.

    Each batch takes the next slot in turn. :meth:`put` copies its frames
    into the slot's host buffer (a few threads side by side, each a block
    of frames), :meth:`upload` enqueues their copy to the
    device, :meth:`send` enqueues the copy of the batch's packed result
    into the slot's host result buffer, and :meth:`fetch` waits for that
    copy alone and returns the result as a new numpy array.

    On a CUDA device the host buffers are pinned, so both copies run
    without blocking. A buffer is allocated from torch's caching host
    allocator when a slot first needs it, or needs a larger one. Each slot
    records two events on the current stream, "upload done" after the
    upload and "result copied" after the result's copy. A fetch waits on
    its batch's "result copied" event, never on the whole stream. A put
    first waits until the slot's previous upload is done. On the CPU the
    buffers are plain tensors, there are no events, and the upload returns
    the slot's own buffer. ``event`` makes the events (default
    ``torch.cuda.Event`` on a CUDA device, none on the CPU): anything with
    ``record()``, ``query()`` and ``synchronize()``.

    A pipeline of depth d holds d batches in flight while it stages the
    next one, so it needs d + 1 slots. Restaging a slot whose batch was not
    fetched raises.

    ``stats``: ``batches`` staged; ``fetch_waited``, fetches whose result
    copy had not completed when asked; ``slot_waited``, puts that found
    their slot's previous upload still running.
    """

    def __init__(self, device, slots: int, event: Callable | None = None):
        self.device = torch.device(device)
        self._pinned = self.device.type == "cuda"
        self._event = torch.cuda.Event if event is None and self._pinned else event
        self._slots = [_Slot() for _ in range(slots)]
        self._next = 0
        self.stats = {"batches": 0, "fetch_waited": 0, "slot_waited": 0}

    def put(self, frames: list) -> _Slot:
        """The next slot, holding ``frames`` (equal-shape arrays) as
        float32."""
        slot = self._slots[self._next]
        if slot.busy:
            raise RuntimeError("transfer slot restaged before its batch was fetched: "
                               "the ring has fewer slots than batches in flight")
        self._next = (self._next + 1) % len(self._slots)
        self._wait(slot.uploaded, "slot_waited")
        slot.busy = True
        self.stats["batches"] += 1
        slot.frames_shape = (len(frames),) + np.shape(frames[0])
        slot.frames = self._fit(slot.frames, slot.frames_shape, torch.float32)
        _copy_rows(_view(slot.frames, slot.frames_shape).numpy(), frames)
        return slot

    def upload(self, slot: _Slot) -> torch.Tensor:
        """The slot's frames [n, H, W] on the device (enqueued)."""
        out = _view(slot.frames, slot.frames_shape).to(self.device, non_blocking=True)
        slot.uploaded = self._record(slot.uploaded)
        return out

    def send(self, slot: _Slot, result: torch.Tensor) -> None:
        """Enqueue the copy of the batch's ``result`` (on the device) into
        the slot."""
        slot.result_shape = tuple(result.shape)
        slot.result = self._fit(slot.result, slot.result_shape, result.dtype)
        _view(slot.result, slot.result_shape).copy_(result, non_blocking=True)
        slot.copied = self._record(slot.copied)

    def fetch(self, slot: _Slot) -> np.ndarray:
        """The batch's result, once its copy is done: a new array, so the
        slot can take the next batch."""
        self._wait(slot.copied, "fetch_waited")
        out = _view(slot.result, slot.result_shape).numpy().copy()
        slot.busy = False
        return out

    def _fit(self, buf: torch.Tensor | None, shape: tuple, dtype) -> torch.Tensor:
        """``buf``, or a new host buffer where it is missing, too small or of
        another dtype."""
        if buf is None or buf.numel() < math.prod(shape) or buf.dtype != dtype:
            buf = torch.empty(math.prod(shape), dtype=dtype, pin_memory=self._pinned)
        return buf

    def _record(self, event):
        if self._event is None:
            return None
        event = event if event is not None else self._event()
        event.record()
        return event

    def _wait(self, event, count: str) -> None:
        if event is not None and not event.query():
            self.stats[count] += 1
            event.synchronize()


# Threads of a slot's frame copy. The copy is bound by memory bandwidth
# more than by one core: 33 frames of 376x1241 float32 into pinned memory
# took 11.2 ms on one thread, 3.6 ms on 4 and 2.7 ms on 8 (the host of an
# H100 machine); 4 leave the host's other cores to its other work.
_COPY_THREADS = 4


def _copy_rows(dst: np.ndarray, frames: list) -> None:
    """``dst[k] = frames[k]`` for every k, in up to ``_COPY_THREADS``
    contiguous blocks copied side by side (numpy lets go of the
    interpreter lock while it copies)."""
    n = min(_COPY_THREADS, len(frames))
    cuts = [len(frames) * i // n for i in range(n + 1)]

    def copy(i: int) -> None:
        for k in range(cuts[i], cuts[i + 1]):
            dst[k] = frames[k]

    with ThreadPoolExecutor(n) as pool:
        list(pool.map(copy, range(n)))


def _view(buf: torch.Tensor, shape: tuple) -> torch.Tensor:
    return buf[:math.prod(shape)].view(shape)
