"""Raw frames of a camera with a radial-tangential lens, made from the seed.

The corridor of ``frames.py`` is rendered without noise through the
camera's pinhole part on a canvas wide enough for every ray of the raw
frame; each raw pixel then takes the canvas's bilinear sample at its
undistorted position (the lens model inverted in float64 to 1e-10), and
only then the sensor noise, rounded to whole grey levels as an 8-bit
sensor gives them. The seed's uses follow ``frames.render``: the scene's
textures, the starting phase, the motion and the noise.
"""

from __future__ import annotations

import numpy as np

from benchmark.yardstick import frames, photoreal

TOL = 1e-10  # the inverted lens model's largest residual, normalized units


def _distort(x: np.ndarray, y: np.ndarray, d: dict):
    """Normalized pinhole points (x, y) as the lens shows them."""
    r2 = x * x + y * y
    radial = 1.0 + d["k1"] * r2 + d["k2"] * r2 * r2
    return (x * radial + 2 * d["p1"] * x * y + d["p2"] * (r2 + 2 * x * x),
            y * radial + d["p1"] * (r2 + 2 * y * y) + 2 * d["p2"] * x * y)


def pinhole_positions(camera: dict, distortion: dict):
    """(X, Y) [H, W] float64: where each raw pixel's ray meets the pinhole
    image of the same K, by fixed-point iteration of the lens model."""
    H, W = camera["height"], camera["width"]
    v, u = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64),
                       indexing="ij")
    xd = (u - camera["cx"]) / camera["fx"]
    yd = (v - camera["cy"]) / camera["fy"]
    x, y = xd.copy(), yd.copy()
    for _ in range(500):
        gx, gy = _distort(x, y, distortion)
        ex, ey = gx - xd, gy - yd
        if max(np.abs(ex).max(), np.abs(ey).max()) < TOL:
            return camera["fx"] * x + camera["cx"], camera["fy"] * y + camera["cy"]
        r2 = x * x + y * y
        radial = 1.0 + distortion["k1"] * r2 + distortion["k2"] * r2 * r2
        x, y = x - ex / radial, y - ey / radial
    raise ValueError("the lens model did not invert to 1e-10 in 500 iterations")


def _bilinear(img: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    x0 = np.floor(X).astype(np.int64)
    y0 = np.floor(Y).astype(np.int64)
    fx, fy = X - x0, Y - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def render(seed: int, n: int, camera: dict, distortion: dict, exposure_drift: float = 0.15,
           noise_sigma: float = 2.0, motion: dict | None = None) -> np.ndarray:
    """[n, H, W] float32 raw frames (whole grey levels) of the corridor seen
    through ``camera`` and its lens ``distortion`` (k1, k2, p1, p2), moving
    as ``motion`` says (``frames.trajectory``'s keywords)."""
    rng = np.random.default_rng(seed)
    scene = photoreal.CorridorScene(seed=int(rng.integers(0, 2**31 - 4)))
    textures = scene.textures()
    H, W = camera["height"], camera["width"]
    phase = float(rng.integers(0, 200))
    poses = frames.trajectory(n, phase=phase, **(motion or {}))
    frng = np.random.default_rng(rng.integers(0, 2**63))
    X, Y = pinhole_positions(camera, distortion)
    # The canvas: the pinhole frame grown by the rays' reach past each side.
    mx = int(np.ceil(max(-X.min(), X.max() - (W - 1), 0.0))) + 2
    my = int(np.ceil(max(-Y.min(), Y.max() - (H - 1), 0.0))) + 2
    K = np.array([[camera["fx"], 0, camera["cx"] + mx], [0, camera["fy"], camera["cy"] + my],
                  [0, 0, 1.0]])
    out = np.empty((n, H, W), np.float32)
    for f in range(n):
        g = f + phase
        canvas = photoreal.render_frame(
            scene, textures, K, poses[f], H + 2 * my, W + 2 * mx,
            exposure=1.0 + exposure_drift * np.sin(0.05 * g),
            bias=4.0 * np.sin(0.03 * g + 1.0), noise_sigma=0.0)
        raw = _bilinear(canvas.astype(np.float64), X + mx, Y + my)
        raw = raw + frng.normal(0.0, noise_sigma, raw.shape)
        out[f] = np.clip(np.rint(raw), 0, 255)
    return out
