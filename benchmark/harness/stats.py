"""The statistics of a run: a rate over the whole window, and the busy
time and idle share of a device timeline."""

from __future__ import annotations


def rate(done: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return done / seconds


def union_length(intervals) -> float:
    """Total length covered by intervals (start, end), overlaps counted
    once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The idle stretches (start, end) of [start, end] between intervals."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [g for g in out if g[1] > g[0]]


def idle_share_pct(busy_per_call_s: float, wall_per_call_s: float) -> float:
    """Share of a call's untraced wall time in which the device ran
    nothing, in percent."""
    return 100.0 * (1.0 - busy_per_call_s / wall_per_call_s)
