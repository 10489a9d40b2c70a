"""The least time of a call's undistortion on the card: each distinct raw
frame a step is given (its B pairs hold B + 1 frames) read once and its
undistorted copy written once, 8 bytes a pixel (float32 in and out). The
operations are not counted: the same frames need the same bytes whatever
computes the map. A step that undistorts its source and its target frames
apart does nearly twice this work, and its share of the roofline shows
that gap.
"""

from __future__ import annotations

from benchmark.yardstick import work


def bound_s(frames: int, H: int, W: int) -> float:
    """Least seconds of undistorting ``frames`` frames of H x W."""
    return work.bound_s(frames * H * W * (4 + 4), 0)
