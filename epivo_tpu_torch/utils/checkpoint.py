"""Checkpoint / resume for long sequence runs (port of
``epivo_tpu/utils/checkpoint.py``, plain numpy, copied).

Periodic ``.npz`` snapshots of the runner state (relative poses so far,
per-frame diagnostics, extracted pairs) keyed by frame index; a resumed
run picks up at the last completed frame.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np


class SequenceCheckpointer:
    """Snapshot/restore for sequence-runner state. A ``read_only``
    checkpointer restores and keeps the same buckets but writes nothing
    (the ranks of a mesh other than rank 0: two ranks never write one
    file)."""

    def __init__(self, directory: str, every: int = 50, read_only: bool = False):
        self.dir = directory
        self.every = every
        self.read_only = read_only
        self._last_bucket = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, frame_idx: int) -> str:
        return os.path.join(self.dir, f"ckpt_{frame_idx:08d}.npz")

    def due(self, frame_idx: int) -> bool:
        """True when :meth:`maybe_save` would save at this index — lets
        callers skip assembling an expensive state dict between buckets."""
        return frame_idx != 0 and frame_idx // self.every > self._last_bucket

    def maybe_save(self, frame_idx: int, state: dict) -> bool:
        """Save when a new ``every``-sized bucket is crossed (robust to
        callers advancing by batches that don't divide ``every``)."""
        if not self.due(frame_idx):
            return False
        self._last_bucket = frame_idx // self.every
        self.save(frame_idx, state)
        return True

    def save(self, frame_idx: int, state: dict) -> None:
        if self.read_only:
            return
        arrays = {k: np.asarray(v) for k, v in state.items()}
        tmp = self._path(frame_idx) + ".tmp.npz"  # .npz keeps savez literal
        np.savez(tmp, **arrays)
        os.replace(tmp, self._path(frame_idx))
        with open(os.path.join(self.dir, "LATEST"), "w") as f:
            json.dump({"frame": frame_idx}, f)

    def latest(self) -> int | None:
        """Highest checkpointed frame index, or None."""
        marker = os.path.join(self.dir, "LATEST")
        if os.path.exists(marker):
            with open(marker) as f:
                idx = json.load(f)["frame"]
            if os.path.exists(self._path(idx)):
                return idx
        best = None
        for fn in os.listdir(self.dir):
            m = re.match(r"ckpt_(\d+)\.npz$", fn)
            if m:
                best = max(best or 0, int(m.group(1)))
        return best

    def restore(self, frame_idx: int | None = None) -> tuple[int, dict] | None:
        idx = frame_idx if frame_idx is not None else self.latest()
        if idx is None:
            return None
        with np.load(self._path(idx), allow_pickle=False) as z:
            return idx, {k: z[k] for k in z.files}
