"""Oriented BRIEF (ORB-class) descriptors, batched (port of
``epivo_tpu/frontend/orb.py``).

- orientation by intensity centroid over a circular patch (the ORB
  "oFAST" moment method);
- rotation-steered binary tests from a fixed, seeded Gaussian BRIEF
  pattern (bit-equal to the reference's);
- the 37x37 window around each keypoint comes from
  :func:`klt._extract_windows`, so on a CUDA tensor the window-extraction
  kernel (``csrc/klt_extract.cu``) runs once per call; the 2 x 256 point
  samples are bilinear, by direct gathers from those windows. The
  reference's one-hot-matmul sampler exists only for the TPU and is not
  ported.

Descriptors come as {-1, +1} float vectors [..., K, 256], so Hamming
distance is one matmul (:mod:`epivo_tpu_torch.frontend.match`), plus a
bit-packed uint32 view [..., K, 8]. Every function takes images [H, W]
with keypoints [K, 2], or [B, H, W] with [B, K, 2].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from epivo_tpu_torch._device import constant
from epivo_tpu_torch.frontend import fast as fast_mod, image as imops, klt

N_BITS = 256
PATCH = 31  # ORB patch diameter for moments/pattern
_S = 37  # window size: PATCH + margin for rotated samples


class Descriptors(NamedTuple):
    signs: torch.Tensor  # [..., K, 256] float {-1, +1}
    packed: torch.Tensor  # [..., K, 8] uint32 bit-packed
    angle: torch.Tensor  # [..., K] radians
    valid: torch.Tensor  # [..., K] bool


def brief_pattern(seed: int = 7) -> np.ndarray:
    """[256, 4] (ax, ay, bx, by) test-pair offsets: both endpoints drawn
    from N(0, (PATCH/5)^2) and clipped to the patch radius less 2."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 4))
    r = PATCH // 2 - 2
    return np.clip(pts, -r, r).astype(np.float32)


_PATTERN = brief_pattern()


def orientation(windows: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per window [..., S, S] -> [...] radians,
    from the moments over the centred circular patch of diameter PATCH.

    The moments accumulate in float64 (each product of a float32 sample
    and a half-integer offset is exact there), so the float32 angle does
    not depend on how the reduction splits its sums, which varies with the
    batch the window sits in."""
    S = windows.shape[-1]
    r = torch.arange(S, dtype=torch.float64, device=windows.device) - (S - 1) / 2.0
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    circ = (xx**2 + yy**2) <= (PATCH / 2.0) ** 2
    w = windows.to(torch.float64) * circ
    m10 = torch.sum(w * xx, dim=(-2, -1))
    m01 = torch.sum(w * yy, dim=(-2, -1))
    return torch.atan2(m01, m10).to(windows.dtype)


def _sample_points(windows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of windows [..., K, S, S] at q [..., K, P, 2] (x, y)
    in window coordinates -> [..., K, P]: four gathers and the reference's
    blend (rows first, then columns), positions clamped to [0, S - 1.001]."""
    S = windows.shape[-1]
    c = torch.clamp(q, 0.0, S - 1.001)
    fl = torch.floor(c)
    f = c - fl
    i0 = fl.long()
    x0, y0 = i0[..., 0], i0[..., 1]
    fx, fy = f[..., 0], f[..., 1]
    flat = windows.flatten(-2)
    tap = lambda y, x: torch.gather(flat, -1, y * S + x)
    col0 = (1 - fy) * tap(y0, x0) + fy * tap(y0 + 1, x0)
    col1 = (1 - fy) * tap(y0, x0 + 1) + fy * tap(y0 + 1, x0 + 1)
    return (1 - fx) * col0 + fx * col1


def describe(img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor | None = None,
             use_kernel: bool | None = None) -> Descriptors:
    """Oriented BRIEF descriptors at keypoints xy [..., K, 2] of img
    [..., H, W] (no leading axis, or one batch axis). ``use_kernel`` picks
    the window-extraction route (:func:`klt.extract_windows`)."""
    wins, origins = klt._extract_windows(img, xy, _S, use_kernel)
    ang = orientation(wins)
    ca, sa = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    ax, ay, bx, by = constant(_PATTERN, img.dtype, img.device).unbind(-1)

    ctr = xy - origins  # keypoint position within its window

    def positions(px, py):
        rx = ca * px - sa * py  # [..., K, 256] rotated offsets
        ry = sa * px + ca * py
        return torch.stack([ctr[..., 0:1] + rx, ctr[..., 1:2] + ry], dim=-1)

    va = _sample_points(wins, positions(ax, ay))
    vb = _sample_points(wins, positions(bx, by))
    signs = torch.where(va > vb, 1.0, -1.0).to(img.dtype)  # [..., K, 256]

    bits = (signs > 0).long().reshape(*signs.shape[:-1], 8, 32)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=img.device)
    packed = torch.sum(bits * weights, dim=-1).to(torch.uint32)  # [..., K, 8]

    v = (torch.ones(xy.shape[:-1], dtype=torch.bool, device=img.device)
         if valid is None else valid)
    return Descriptors(signs=signs, packed=packed, angle=ang, valid=v)


def level_budgets(max_keypoints: int, n_levels: int, scale_factor: float) -> list[int]:
    """Per-level keypoint budgets proportional to each level's area
    (a geometric series), at least 8 each, summing to ``max_keypoints``."""
    areas = [scale_factor ** (-2 * lv) for lv in range(n_levels)]
    total = sum(areas)
    budgets = [max(8, int(round(max_keypoints * a / total))) for a in areas]
    budgets[0] += max_keypoints - sum(budgets)
    return budgets


def detect_and_describe_pyramid(
    img: torch.Tensor,
    threshold: float = 40.0,
    max_keypoints: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    use_kernel: bool | None = None,
):
    """Multi-scale ORB: FAST on a scale pyramid + oriented BRIEF, for img
    [H, W] or a stack [B, H, W].

    Each level gets a keypoint budget proportional to its area
    (:func:`level_budgets`); levels smaller than 2 * PATCH get none.
    Detection and description run on the downscaled level (3-tap binomial
    blur, then :func:`image.resize_linear`), one :func:`fast.detect` and
    one :func:`describe` per level for the whole stack, and keypoint
    coordinates are mapped back to level-0 pixels.

    Returns ``(Keypoints, Descriptors, levels)``: keypoints in level-0
    coordinates with FAST scores, the descriptors, and ``levels`` [..., K]
    int32 pyramid-level indices.
    """
    budgets = level_budgets(max_keypoints, n_levels, scale_factor)
    xs, scores, valids, levels = [], [], [], []
    sign_list, packed_list, angle_list = [], [], []
    cur = img
    cur_scale = 1.0
    blur = (0.25, 0.5, 0.25)
    for lv in range(n_levels):
        if min(cur.shape[-2:]) < 2 * PATCH:
            budgets[lv] = 0
        if budgets[lv] > 0:
            kp = fast_mod.detect(cur, threshold, budgets[lv], use_kernel=use_kernel)
            d = describe(cur, kp.xy, kp.valid, use_kernel=use_kernel)
            xs.append(kp.xy * cur_scale)
            scores.append(kp.score)
            valids.append(kp.valid & d.valid)
            levels.append(torch.full(kp.score.shape, lv, dtype=torch.int32,
                                     device=img.device))
            sign_list.append(d.signs)
            packed_list.append(d.packed)
            angle_list.append(d.angle)
        if lv < n_levels - 1:
            nh = max(int(round(cur.shape[-2] / scale_factor)), 1)
            nw = max(int(round(cur.shape[-1] / scale_factor)), 1)
            cur = imops.resize_linear(imops._sep_conv3(cur, blur, blur), nh, nw)
            cur_scale *= scale_factor

    if not xs:
        raise ValueError(
            f"detect_and_describe_pyramid: image {tuple(img.shape[-2:])} is "
            f"smaller than 2*PATCH={2 * PATCH} at every level; no level can "
            "host the oriented-BRIEF patch (use plain describe(), or a "
            "bigger image).")
    kps = fast_mod.Keypoints(xy=torch.cat(xs, dim=-2), score=torch.cat(scores, dim=-1),
                             valid=torch.cat(valids, dim=-1))
    descs = Descriptors(signs=torch.cat(sign_list, dim=-2),
                        packed=torch.cat(packed_list, dim=-2),
                        angle=torch.cat(angle_list, dim=-1), valid=kps.valid)
    return kps, descs, torch.cat(levels, dim=-1)
