"""The VO cells' camera stream, made from the seed.

A street corridor rendered by the frozen renderer through the
configuration's camera. By default the camera follows the port's
``corridor_sequence`` trajectory: forward motion of about 0.8 m a frame
with a 30 % speed wobble, slow yaw and a small lateral sway. A
configuration may state its own ``motion`` (the keyword arguments of
``trajectory``: ``speed``, ``yaw_rate``, ``speed_wobble``, ``sway``),
such as a hand-held or flying camera's slow pace. A few frames are
rendered once at set-up and played forward and then back, so that every
consecutive pair of the stream is a real motion.
"""

from __future__ import annotations

import numpy as np

from benchmark.yardstick import photoreal


def trajectory(n: int, speed: float = 0.8, yaw_rate: float = 0.002,
               speed_wobble: float = 0.3, sway: float = 0.02,
               phase: float = 0.0) -> np.ndarray:
    """Camera-to-world poses [n, 4, 4] of a drive started at ``phase``
    frames in; the defaults are the port's ``corridor_sequence`` motion.

    ``speed`` is metres a frame along the optical axis, wobbling by the
    share ``speed_wobble``; ``yaw_rate`` radians a frame, wobbling by half;
    ``sway`` the lateral amplitude in metres."""
    out, T = [], np.eye(4)
    for f in range(n):
        out.append(T.copy())
        g = f + phase
        s = speed * (1.0 + speed_wobble * np.sin(0.13 * g))
        yaw = yaw_rate * (1.0 + 0.5 * np.sin(0.04 * g))
        cy, sy = np.cos(yaw), np.sin(yaw)
        step = np.eye(4)
        step[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        step[:3, 3] = [sway * np.sin(0.2 * g), 0.0, s]
        T = T @ step
    return np.stack(out)


def render(seed: int, n: int, camera: dict, exposure_drift: float = 0.15,
           noise_sigma: float = 2.0, motion: dict | None = None) -> np.ndarray:
    """[n, H, W] float32 frames of a corridor whose textures, starting
    phase and sensor noise all come from ``seed``, seen from a camera that
    moves as ``motion`` (``trajectory``'s keywords) says, or on the
    corridor drive without it."""
    rng = np.random.default_rng(seed)
    scene = photoreal.CorridorScene(seed=int(rng.integers(0, 2**31 - 4)))
    textures = scene.textures()
    K = np.array([[camera["fx"], 0, camera["cx"]], [0, camera["fy"], camera["cy"]],
                  [0, 0, 1.0]])
    H, W = camera["height"], camera["width"]
    phase = float(rng.integers(0, 200))
    poses = trajectory(n, phase=phase, **(motion or {}))
    frng = np.random.default_rng(rng.integers(0, 2**63))
    frames = np.empty((n, H, W), np.float32)
    for f in range(n):
        g = f + phase
        frames[f] = photoreal.render_frame(
            scene, textures, K, poses[f], H, W,
            exposure=1.0 + exposure_drift * np.sin(0.05 * g),
            bias=4.0 * np.sin(0.03 * g + 1.0), noise_sigma=noise_sigma, rng=frng)
    return frames


def pingpong(k: int, n: int) -> int:
    """The rendered frame shown at stream position k: 0, 1, ..., n - 1,
    n - 2, ..., 1, 0, 1, ..."""
    period = 2 * n - 2
    r = k % period
    return r if r < n else period - r


def stream(start: int, length: int, n: int) -> list[int]:
    """Rendered-frame indices of ``length`` stream positions from ``start``."""
    return [pingpong(start + k, n) for k in range(length)]
