"""Photometrically realistic synthetic sequences (textured corridor scene).

A copy of ``epivo_tpu/datasets/photoreal.py`` (pure numpy): the functions
and their output are bit-identical, so the port can render the bench's
frames without JAX. The fixture renders a KITTI-like street corridor with
the failure modes real footage has and Gaussian-blob images lack:

- **dense multi-scale texture** on every surface (band-limited value noise
  + stripes), so FAST/KLT see realistic ambiguous gradients, not isolated
  peaks;
- **true occlusion boundaries**: ground plane + two facades + back wall,
  z-buffered per pixel — features appear/disappear at depth edges;
- **perspective foreshortening**: textures are sampled in world
  coordinates on each plane, so image-space texture frequency varies with
  depth (the KLT aperture problem gets harder with distance);
- **photometric drift**: per-frame exposure gain/bias drift plus a static
  vignette — violating brightness constancy the way auto-exposure does;
- **sensor noise**: per-pixel Gaussian noise re-drawn every frame.

Rendering is plane-wise inverse warping (ray/plane intersection per
pixel), vectorized numpy on host — the same role as the reference's
dataset adapters (`kitti_ba.cpp:1097-1102` load real frames; we fabricate
equivalent ones).
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


def corridor_sequence(
    F: int,
    H: int = 376,
    W: int = 1241,
    K: np.ndarray | None = None,
    scene: CorridorScene = CorridorScene(),
    speed: float = 0.8,
    yaw_rate: float = 0.002,
    speed_wobble: float = 0.3,
    exposure_drift: float = 0.15,
    noise_sigma: float = 2.0,
    seed: int = 0,
):
    """Generate (frames iterator, gt_poses [F, 4, 4]) for a driving-style
    trajectory: forward motion with speed variation and slow yaw.

    ``exposure_drift`` is the peak relative gain drift over the sequence
    (sinusoidal, like slow auto-exposure hunting).
    """
    if K is None:
        K = np.array([[718.856, 0, W / 2.0], [0, 718.856, H / 2.0],
                      [0, 0, 1.0]])
    textures = scene.textures()
    rng = np.random.default_rng(seed + 100)

    gt = []
    T = np.eye(4)
    for f in range(F):
        gt.append(T.copy())
        s = speed * (1.0 + speed_wobble * np.sin(0.13 * f))
        yaw = yaw_rate * (1.0 + 0.5 * np.sin(0.04 * f))
        cy, sy = np.cos(yaw), np.sin(yaw)
        step = np.eye(4)
        step[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        step[:3, 3] = [0.02 * np.sin(0.2 * f), 0.0, s]
        T = T @ step
    gt = np.stack(gt)

    def frames():
        frng = np.random.default_rng(seed + 200)
        for f in range(F):
            expo = 1.0 + exposure_drift * np.sin(0.05 * f)
            bias = 4.0 * np.sin(0.03 * f + 1.0)
            yield render_frame(scene, textures, K, gt[f], H, W,
                               exposure=expo, bias=bias,
                               noise_sigma=noise_sigma, rng=frng)

    return frames(), gt, K


def corridor_stereo_sequence(
    F: int,
    H: int = 376,
    W: int = 1241,
    K: np.ndarray | None = None,
    baseline: float = 0.54,
    scene: CorridorScene = CorridorScene(),
    seed: int = 0,
    **kwargs,
):
    """Stereo variant of :func:`corridor_sequence`: KITTI-style rig (right
    camera at +x in the left frame; ``T_rig[0, 3] = -baseline``).

    Returns (left_frames_iter, right_frames_iter, gt [F, 4, 4], K, T_rig).
    The two iterators render lazily and independently (each own pass), so
    streamed consumers keep bounded memory.
    """
    if K is None:
        K = np.array([[718.856, 0, W / 2.0], [0, 718.856, H / 2.0],
                      [0, 0, 1.0]])
    _, gt, _ = corridor_sequence(F, H=H, W=W, K=K, scene=scene, seed=seed,
                                 **kwargs)
    T_rig = np.eye(4, dtype=np.float32)
    T_rig[0, 3] = -baseline
    textures = scene.textures()

    def cam_frames(offset_x: float, rng_seed: int):
        frng = np.random.default_rng(rng_seed)
        for f in range(F):
            expo = 1.0 + 0.15 * np.sin(0.05 * f)
            bias = 4.0 * np.sin(0.03 * f + 1.0)
            T_wc = gt[f].copy()
            # Right camera center: c + R @ [baseline, 0, 0].
            T_wc[:3, 3] = T_wc[:3, 3] + T_wc[:3, :3] @ np.array(
                [offset_x, 0.0, 0.0])
            yield render_frame(scene, textures, K, T_wc, H, W,
                               exposure=expo, bias=bias, rng=frng)

    return (cam_frames(0.0, seed + 200), cam_frames(baseline, seed + 300),
            gt, K, T_rig)


def loop_trajectory(
    n_out: int = 60,
    n_turn: int = 52,
    n_back: int = 60,
    n_close: int = 12,
    speed: float = 0.6,
    turn_speed: float = 0.15,
    lateral: float = 4.8,
    close_offset: float = 0.0,
    laps: int = 1,
):
    """Out-and-back loop course inside the corridor: straight out, slow
    180-degree arc (radius ~ turn_speed * n_turn / pi, bounded by the
    corridor half-width), straight back along the other lane, second arc,
    and a short closing straight that re-traverses the start region with
    the ORIGINAL heading — the final frames see the same view as the
    first ones, which is what loop-closure detection needs.

    ``laps`` > 1 repeats the full out-turn-back-turn circuit: every lap
    re-traverses both straights, so the course carries SEVERAL true
    revisits with overlapping spans — the multi-loop fixture for the
    joint Sim(3) pose-graph correction (single-loop greedy spreading can
    apply only one constraint per span).

    ``close_offset`` laterally offsets the closing straight from the
    outbound lane (by tightening the second arc): the revisit then
    passes ``close_offset`` metres from the original keyframes — a
    NONZERO-baseline loop that exercises the scaled-translation branch
    of ``loopclose.verify_loop`` (depth-ratio norm recovery) instead of
    the zero-baseline coincidence branch.

    Returns gt [F, 4, 4] camera-to-world poses (+z forward, yaw about +y,
    same composition convention as :func:`corridor_sequence`).
    """
    d_yaw = np.pi / n_turn
    # A 180-degree arc displaces the lane by 2R = 2 * v * n / pi; trim
    # the second arc's speed so the closing lane lands close_offset off
    # the outbound lane.
    turn_speed2 = max(0.02, turn_speed - close_offset * np.pi / (2 * n_turn))
    phases = (
        [(0.0, speed)] * n_out
        + [(d_yaw, turn_speed)] * n_turn
        + [(0.0, speed)] * n_back
        + [(d_yaw, turn_speed2)] * n_turn
    ) * max(1, laps) + [(0.0, speed)] * n_close
    # Smooth the speed transitions (vehicles decelerate over several
    # frames; a hard 4x per-frame speed step would also read as a
    # catastrophic boundary to the scale chain's temporal gate).
    ramp = 8
    sp = np.array([s for _, s in phases])
    k = np.ones(ramp) / ramp
    sp = np.convolve(np.concatenate([sp[:1].repeat(ramp // 2), sp,
                                     sp[-1:].repeat(ramp - 1 - ramp // 2)]),
                     k, mode="valid")
    phases = [(y, s) for (y, _), s in zip(phases, sp)]
    gt = []
    T = np.eye(4)
    for yaw, s in phases:
        gt.append(T.copy())
        cy, sy = np.cos(yaw), np.sin(yaw)
        step = np.eye(4)
        step[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        step[:3, 3] = [0.0, 0.0, s]
        T = T @ step
    gt = np.stack(gt)
    # Keep the course inside the corridor (|x| < wall_x): the arc's
    # lateral displacement is 2 * radius; rescale x if needed (only when
    # no deliberate closing offset is requested — rescaling would
    # distort it).
    x = gt[:, 0, 3]
    span = x.max() - x.min()
    if span > lateral and close_offset == 0.0:
        gt[:, 0, 3] *= lateral / span
    return gt


def loop_sequence(
    H: int = 376,
    W: int = 1241,
    K: np.ndarray | None = None,
    scene: CorridorScene = CorridorScene(),
    exposure_drift: float = 0.15,
    noise_sigma: float = 2.0,
    seed: int = 0,
    **traj_kwargs,
):
    """Photoreal out-and-back loop sequence (frames iterator, gt, K).

    Same renderer and photometric model as :func:`corridor_sequence`, on
    the :func:`loop_trajectory` course — the loop-closure fixture (the
    reference has no loop-capable dataset generator at all).
    """
    if K is None:
        K = np.array([[718.856, 0, W / 2.0], [0, 718.856, H / 2.0],
                      [0, 0, 1.0]])
    gt = loop_trajectory(**traj_kwargs)
    textures = scene.textures()

    def frames():
        frng = np.random.default_rng(seed + 200)
        for f in range(len(gt)):
            expo = 1.0 + exposure_drift * np.sin(0.05 * f)
            bias = 4.0 * np.sin(0.03 * f + 1.0)
            yield render_frame(scene, textures, K, gt[f], H, W,
                               exposure=expo, bias=bias,
                               noise_sigma=noise_sigma, rng=frng)

    return frames(), gt, K
