"""Carry state across from the JAX package, without importing it.

The port has no learned weights; what comes across is the configuration
(two-view ``VOConfig`` or windowed ``BAConfig``) and, for parity runs, the
RANSAC minimal samples (the reference draws them with ``jax.random``,
which torch cannot reproduce).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from epivo_tpu_torch.geometry.camera import Pinhole
from epivo_tpu_torch.pipeline.config import (
    BAConfig, FrontendConfig, GlobalBAConfig, LMConfig, LoopConfig, RansacConfig,
    ScaleConfig, VOConfig,
)

_VO_NESTED = {"camera": Pinhole, "frontend": FrontendConfig,
              "ransac": RansacConfig, "lm": LMConfig}
_NESTED = {
    VOConfig: _VO_NESTED,
    BAConfig: {**_VO_NESTED, "scale": ScaleConfig, "global_ba": GlobalBAConfig,
               "loop": LoopConfig},
}


def _fields_of(obj) -> dict:
    """Field values of a dataclass instance or of ``dataclasses.asdict`` of one."""
    if isinstance(obj, Mapping):
        return dict(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    raise TypeError(f"expected a config dataclass or a dict, got {type(obj).__name__}")


def _convert(cls, obj):
    src = _fields_of(obj)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(src) - known)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {unknown}")
    nested = _NESTED.get(cls, {})
    return cls(**{name: _convert(nested[name], val) if name in nested else val
                  for name, val in src.items()})


def config_from_reference(obj) -> VOConfig | BAConfig:
    """The port's :class:`VOConfig` or :class:`BAConfig` from the
    reference's config of the same name.

    Takes the reference dataclass (read by attribute) or
    ``dataclasses.asdict`` of it, copies it and every config it nests field
    by field, and raises on a field the port does not know. A config with
    fields beyond ``VOConfig``'s is read as a ``BAConfig``.
    """
    vo_fields = {f.name for f in dataclasses.fields(VOConfig)}
    cls = VOConfig if set(_fields_of(obj)) <= vo_fields else BAConfig
    return _convert(cls, obj)


def ransac_samples_from_reference(idx_np, device=None) -> torch.Tensor:
    """The reference's sample indices [n_hyp, 8], or [B, n_hyp, 8] for B
    pairs (a numpy array, e.g. from ``epivo_tpu.ransac._sample_indices``),
    as the LongTensor that ``ransac_essential``, ``vo_step`` and
    ``vo_step_batched`` accept."""
    idx = np.asarray(idx_np)
    if idx.ndim not in (2, 3) or not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"expected an integer [n_hyp, 8] or [B, n_hyp, 8] "
                         f"array, got {idx.dtype} {idx.shape}")
    return torch.as_tensor(idx.astype(np.int64), device=device)
