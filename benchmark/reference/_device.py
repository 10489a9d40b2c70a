"""Host constants on a device, for the frozen copies of the port's plain
code: a copy of the two helpers of ``epivo_tpu_torch/_device.py`` that
they use."""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def to_device(data, dtype: torch.dtype, device) -> torch.Tensor:
    """Host data (nested lists or a numpy array) on ``device``."""
    return torch.as_tensor(data, dtype=dtype).to(device, non_blocking=True)


def constant(data, dtype: torch.dtype, device) -> torch.Tensor:
    """A fixed constant on ``device``, built once per (value, dtype,
    device). Callers never write into the result."""
    arr = np.asarray(data)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, torch.device(device or "cpu"))
    out = _CONSTANTS.get(key)
    if out is None:
        out = _CONSTANTS[key] = to_device(data, dtype, device)
    return out
