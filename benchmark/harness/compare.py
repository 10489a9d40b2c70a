"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference works out again, each held to its
limit from ``limits/<cell>.json``."""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np


def derive(seed: int, *path) -> int:
    """A 63-bit seed for one use of the run's ``--seed`` (frames, a call,
    a step): the same seed and path give the same number."""
    h = hashlib.sha256("/".join(map(str, (seed,) + path)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def rot_gap(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle in radians of Ra^T Rb for rotations [..., 3, 3], exact also
    for tiny angles (from the chord, not the trace)."""
    d = np.linalg.norm((np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
                       .reshape(*np.shape(Ra)[:-2], 9), axis=-1)
    return 2.0 * np.arcsin(np.clip(d / (2.0 * math.sqrt(2.0)), 0.0, 1.0))


def dir_gap(ta: np.ndarray, tb: np.ndarray) -> np.ndarray:
    """Angle in radians between the directions of vectors [..., 3]."""
    unit = lambda t: np.asarray(t, np.float64) / np.maximum(
        np.linalg.norm(np.asarray(t, np.float64), axis=-1, keepdims=True), 1e-300)
    d = np.linalg.norm(unit(ta) - unit(tb), axis=-1)
    return 2.0 * np.arcsin(np.clip(d / 2.0, 0.0, 1.0))


def rel_gap(a, b, floor: float) -> np.ndarray:
    """|a - b| / max(|b|, floor)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), floor)


def worst(x) -> float:
    """The largest entry (0 for none; inf where any is not finite)."""
    x = np.asarray(x, np.float64).ravel()
    if x.size == 0:
        return 0.0
    return float(np.max(np.where(np.isfinite(x), x, np.inf)))


def spread(name: str, x) -> dict:
    """``name`` (the worst entry), ``name_p90`` and ``name_med`` (the 90th
    percentile and the median entry) of per-item gaps. The worst of a
    robust estimator's answers swings with which hypothesis wins a near
    tie; the quantiles hold a change that moves many answers."""
    x = np.asarray(x, np.float64).ravel()
    if x.size == 0:
        return {name: 0.0, name + "_p90": 0.0, name + "_med": 0.0}
    x = np.where(np.isfinite(x), x, np.inf)
    return {name: worst(x), name + "_p90": float(np.percentile(x, 90, method="higher")),
            name + "_med": float(np.median(x))}


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float | None

    @property
    def ok(self) -> bool:
        return self.limit is not None and math.isfinite(self.value) and self.value <= self.limit


def held(readings: dict, limits: dict) -> list[Check]:
    """Each number the cell's limits name beside its limit. Readings the
    limits do not name are not compared (their control reads no more than
    sound runs; ``PERF.md`` gives why); a named number the run did not
    read fails."""
    return [Check(k, float(readings.get(k, math.inf)), float(lim))
            for k, lim in limits.items()]
