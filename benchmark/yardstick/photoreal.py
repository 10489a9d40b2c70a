"""The corridor renderer that makes the VO cells' frames: a frozen copy of
the render half of the port's ``epivo_tpu_torch/datasets/photoreal.py``
(pure numpy), so that a later change to the program cannot change the
frames it is measured on.

A KITTI-like street corridor with the failure modes real footage has:
dense multi-scale texture on every surface, true occlusion boundaries
(ground plane, two facades and a back wall, z-buffered per pixel),
perspective foreshortening, per-frame exposure drift with a static
vignette, and per-pixel sensor noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _value_noise_texture(n: int, seed: int, octaves: int = 5) -> np.ndarray:
    """[n, n] band-limited multi-octave value noise in [0, 255]."""
    rng = np.random.default_rng(seed)
    tex = np.zeros((n, n), np.float64)
    for o in range(octaves):
        k = max(2, n >> (octaves - 1 - o))
        coarse = rng.normal(size=(k, k))
        # Bilinear upsample to n x n.
        yi = np.linspace(0, k - 1, n)
        xi = np.linspace(0, k - 1, n)
        y0 = np.clip(yi.astype(int), 0, k - 2)
        x0 = np.clip(xi.astype(int), 0, k - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (
            coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
            + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
        tex += up / (2.0 ** o)
    # Stripes add oriented structure (window/brick-like repetition).
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    tex += 0.35 * np.sin(2 * np.pi * xx / (n / 24.0))
    tex += 0.25 * np.sin(2 * np.pi * yy / (n / 16.0))
    tex -= tex.min()
    tex *= 255.0 / max(tex.max(), 1e-9)
    return tex.astype(np.float32)


def _sample_tex(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear texture sample with wraparound (tileable)."""
    n = tex.shape[0]
    u = np.mod(u, 1.0) * (n - 1)
    v = np.mod(v, 1.0) * (n - 1)
    x0 = np.clip(u.astype(int), 0, n - 2)
    y0 = np.clip(v.astype(int), 0, n - 2)
    fx = u - x0
    fy = v - y0
    return (
        tex[y0, x0] * (1 - fx) * (1 - fy)
        + tex[y0, x0 + 1] * fx * (1 - fy)
        + tex[y0 + 1, x0] * (1 - fx) * fy
        + tex[y0 + 1, x0 + 1] * fx * fy
    )


@dataclasses.dataclass(frozen=True)
class CorridorScene:
    """Street-corridor geometry (camera starts at origin, +z forward,
    +y down — camera convention)."""

    ground_y: float = 1.6       # ground plane height below camera
    wall_x: float = 6.0         # facades at x = +-wall_x
    back_z: float = 220.0       # far wall
    tex_n: int = 1024
    tex_scale_ground: float = 8.0  # metres per texture tile
    tex_scale_wall: float = 10.0
    seed: int = 0

    def textures(self):
        return (
            _value_noise_texture(self.tex_n, self.seed),
            _value_noise_texture(self.tex_n, self.seed + 1),
            _value_noise_texture(self.tex_n, self.seed + 2),
            _value_noise_texture(self.tex_n, self.seed + 3),
        )


def render_frame(scene: CorridorScene, textures, K: np.ndarray,
                 T_wc: np.ndarray, H: int, W: int,
                 exposure: float = 1.0, bias: float = 0.0,
                 noise_sigma: float = 2.0,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """Render one [H, W] float32 frame from camera-to-world pose T_wc."""
    tex_g, tex_wl, tex_wr, tex_b = textures
    R = T_wc[:3, :3]
    c = T_wc[:3, 3]
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    # World-space ray directions.
    d_cam = np.stack([(xx - K[0, 2]) / K[0, 0],
                      (yy - K[1, 2]) / K[1, 1],
                      np.ones_like(xx)], axis=-1)  # [H, W, 3]
    d = d_cam @ R.T  # world

    depth = np.full((H, W), np.inf)
    img = np.zeros((H, W), np.float64)

    def add_plane(n_vec, offs, tex, uv_fn):
        # Plane: n . X = offs. Ray: X = c + t d -> t = (offs - n.c) / (n.d)
        denom = d @ n_vec
        t = (offs - c @ n_vec) / np.where(np.abs(denom) > 1e-12, denom, 1e-12)
        valid = (t > 0.2) & (np.abs(denom) > 1e-9)
        X = c[None, None] + t[..., None] * d
        u, v = uv_fn(X)
        val = _sample_tex(tex, u, v)
        # z-buffer on camera-frame depth (= t * |d| ~ t, monotone enough).
        closer = valid & (t < depth)
        img[closer] = val[closer]
        depth[closer] = t[closer]

    g = scene.tex_scale_ground
    w = scene.tex_scale_wall
    add_plane(np.array([0.0, 1.0, 0.0]), scene.ground_y, tex_g,
              lambda X: (X[..., 0] / g, X[..., 2] / g))
    add_plane(np.array([1.0, 0.0, 0.0]), -scene.wall_x, tex_wl,
              lambda X: (X[..., 2] / w, X[..., 1] / w))
    add_plane(np.array([1.0, 0.0, 0.0]), scene.wall_x, tex_wr,
              lambda X: (X[..., 2] / w, X[..., 1] / w))
    add_plane(np.array([0.0, 0.0, 1.0]), scene.back_z, tex_b,
              lambda X: (X[..., 0] / w, X[..., 1] / w))

    # Sky where nothing was hit (above the horizon).
    img[np.isinf(depth)] = 140.0

    # Photometric model: vignette + exposure drift + sensor noise.
    r2 = ((xx - W / 2) / (W / 2)) ** 2 + ((yy - H / 2) / (H / 2)) ** 2
    vignette = 1.0 - 0.25 * r2
    img = img * vignette * exposure + bias
    if rng is not None and noise_sigma > 0:
        img = img + rng.normal(0.0, noise_sigma, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)
