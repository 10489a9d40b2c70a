"""The BA cells' windows, made from the seed.

Each window is three frames of a forward drive (two zetas, each mapping
frame j to frame j + 1) with its three constraints, (0, 0), (1, 1) and the
skip (0, 1), of ``n_points`` matches each, in the layout
``pipeline.ba.ba_windows`` takes: T0s [W, 2, 4, 4], p / p_t [W, 3, N, 3]
normalized homogeneous, wreps [W, 3], pmask [W, 3, N]. Matches are scene
points at log-uniform depths seen through the camera, with Gaussian pixel
noise on both sides and a share of outliers displaced in the target. T0s
is the truth perturbed and scaled to unit steps, as two-view estimates
arrive. ``params`` holds the statistics (the configuration's ``windows``
block); every seed gives the same sizes.
"""

from __future__ import annotations

import numpy as np


def _so3_exp(w: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] of rotation vectors [..., 3]."""
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.maximum(th[..., 0], 1e-12)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K[..., 1, 0], K[..., 2, 0], K[..., 2, 1] = k[..., 2], -k[..., 1], k[..., 0]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _poses(rng, W: int, p: dict) -> np.ndarray:
    """True zetas [W, 2, 4, 4]: a small yaw-dominated rotation and a
    forward step of varying length (the zeta's translation points back)."""
    sig = np.radians(np.asarray(p["rot_sigma_deg"]))  # per axis (x, y, z)
    w = rng.normal(size=(W, 2, 3)) * sig
    turn = rng.random((W, 2)) < p["turn_share"]
    w[..., 1] += turn * np.radians(rng.uniform(-p["turn_deg"], p["turn_deg"], (W, 2)))
    R = _so3_exp(w)
    step = np.exp(rng.normal(0.0, p["step_log_sigma"], (W, 2)))
    d = np.stack([rng.normal(0, p["lateral_sigma"], (W, 2)),
                  rng.normal(0, p["vertical_sigma"], (W, 2)), np.ones((W, 2))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    T = np.tile(np.eye(4), (W, 2, 1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = -np.einsum("wzij,wzj->wzi", R, d) * step[..., None]
    return T


def _perturb(rng, T: np.ndarray, p: dict) -> np.ndarray:
    """The initial zetas: rotation and direction perturbed, unit steps."""
    out = T.copy()
    dR = _so3_exp(rng.normal(size=T.shape[:-2] + (3,)) * np.radians(p["init_rot_sigma_deg"]))
    out[..., :3, :3] = dR @ T[..., :3, :3]
    t = T[..., :3, 3] / np.linalg.norm(T[..., :3, 3], axis=-1, keepdims=True)
    t = t + rng.normal(0, p["init_dir_sigma"], t.shape)
    out[..., :3, 3] = t / np.linalg.norm(t, axis=-1, keepdims=True)
    return out


def make(seed: int, W: int, camera: dict, params: dict, n_points: int = 32) -> dict:
    """``W`` windows from ``seed`` (numpy arrays, float32 and bool)."""
    rng = np.random.default_rng(seed)
    p = params
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    Wd, Hd = camera["width"], camera["height"]
    T = _poses(rng, W, p)
    # Constraint r maps its source frame to its target: (0, 0) zeta 0,
    # (1, 1) zeta 1, (0, 1) zeta 1 after zeta 0.
    spans = np.stack([T[:, 0], T[:, 1], T[:, 1] @ T[:, 0]], 1)  # [W, 3, 4, 4]

    n_try = 3 * n_points
    u = rng.uniform(p["border_px"], Wd - 1 - p["border_px"], (W, 3, n_try))
    v = rng.uniform(p["border_px"], Hd - 1 - p["border_px"], (W, 3, n_try))
    z = np.exp(rng.uniform(np.log(p["depth_min"]), np.log(p["depth_max"]), (W, 3, n_try)))
    X = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    Xt = np.einsum("wrij,wrnj->wrni", spans[..., :3, :3], X) + spans[:, :, None, :3, 3]
    ut = fx * Xt[..., 0] / Xt[..., 2] + cx
    vt = fy * Xt[..., 1] / Xt[..., 2] + cy
    seen = ((Xt[..., 2] > 0.5) & (ut >= 0) & (ut <= Wd - 1) & (vt >= 0) & (vt <= Hd - 1))
    # The first n_points seen points of each constraint, in draw order.
    order = np.argsort(~seen, axis=-1, kind="stable")[..., :n_points]
    take = lambda a: np.take_along_axis(a, order, -1)
    u, v, ut, vt, seen = take(u), take(v), take(ut), take(vt), take(seen)

    noise = lambda: rng.normal(0.0, p["pixel_sigma"], u.shape)
    u, v, ut, vt = u + noise(), v + noise(), ut + noise(), vt + noise()
    out = rng.random(u.shape) < p["outlier_share"]
    ang = rng.uniform(0, 2 * np.pi, u.shape)
    mag = rng.uniform(p["outlier_px"][0], p["outlier_px"][1], u.shape)
    ut = ut + out * mag * np.cos(ang)
    vt = vt + out * mag * np.sin(ang)

    full = rng.random((W, 3)) < p["full_share"]
    n_valid = np.where(full, n_points, rng.integers(p["min_valid"], n_points, (W, 3)))
    pmask = (np.arange(n_points) < n_valid[..., None]) & seen

    norm = lambda a, b: np.stack([(a - cx) / fx, (b - cy) / fy, np.ones_like(a)], -1)
    return dict(T0s=_perturb(rng, T, p).astype(np.float32),
                p=norm(u, v).astype(np.float32), p_t=norm(ut, vt).astype(np.float32),
                wreps=np.ones((W, 3), np.float32), pmask=pmask)
