"""FAST-9/16 corner detection with a fixed keypoint budget: a frozen copy
of the port's plain path (``epivo_tpu_torch/frontend/fast.py``), the
oracle of its ``fast_cand`` kernel.

The budget is taken by the two-stage top-k on maps of at least
``TWO_STAGE_MIN_PIXELS`` pixels: the first stage keeps the best 8 of each
16x16 block (:func:`block_candidates`), the second takes the exact top-k of
those candidates (:func:`keypoints_from_candidates`); smaller maps take the
top-k of the whole map. Ties go to the lower index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.ransac import top_k_stable

# Bresenham circle of radius 3: 16 (dy, dx) offsets clockwise from the top.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # FAST-9: at least 9 contiguous circle pixels all brighter/darker

# Maps of at least this many pixels take the two-stage top-k.
TWO_STAGE_MIN_PIXELS = 1 << 16
BLOCK, CANDIDATES = 16, 8  # first stage: block edge, candidates per block


class Keypoints(NamedTuple):
    """Fixed-budget keypoint set."""

    xy: torch.Tensor  # [..., K, 2] float (x, y) pixel coordinates
    score: torch.Tensor  # [..., K] detector response
    valid: torch.Tensor  # [..., K] bool


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9/16 corner response . img [..., H, W];
    returns scores of the same shape, 0 for non-corners and in the 3-pixel
    border.

    Score: max over the 16 arcs of 9 ring pixels of the arc's min
    difference (bright) or minus its max difference (dark).
    """
    H, W = img.shape[-2:]
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1))
                        for dy, dx in CIRCLE])  # [16, ..., H, W]
    diff = ring - img[None]
    idx = (torch.arange(16, device=img.device)[:, None]
           + torch.arange(ARC, device=img.device)[None, :]) % 16  # [16, 9]
    arc_vals = diff[idx]  # [16, 9, ..., H, W]
    arc_min = torch.amin(arc_vals, dim=1)
    arc_max = torch.amax(arc_vals, dim=1)
    bright = torch.amax(arc_min, dim=0)
    dark = torch.amax(-arc_max, dim=0)
    score = torch.maximum(bright, dark)
    score = torch.where(score > threshold, score, 0.0)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return torch.where(interior, score, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression : keep a score that is
    >= all 8 neighbours (outside the image counts as -inf)."""
    H, W = score.shape[-2:]
    p = torch.nn.functional.pad(score, (1, 1, 1, 1), value=-torch.inf)
    neigh = torch.stack([
        p[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1) if not (dy == 0 and dx == 0)
    ])
    keep = score >= torch.amax(neigh, dim=0)
    return torch.where(keep, score, 0.0)


def _padded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def block_candidates(score: torch.Tensor):
    """First stage of the two-stage top-k .

    score: [H, W] or [B, H, W]. The map is zero-padded to (Hp, Wp), the
    next multiples of 16, and cut into nb = (Hp / 16) (Wp / 16) blocks of
    16x16 in row-major order. Each block gives its 8 largest values by
    iterated first-argmax with masking, i.e. in (value descending, in-block
    lane r * 16 + c ascending) order. Returns (val [..., nb, 8], idx
    [..., nb, 8] int32), idx = y * Wp + x in the padded frame; values of
    out-of-image lanes are 0, as in the reference.
    """
    H, W = score.shape[-2:]
    lead = score.shape[:-2]
    Hp, Wp = _padded(H), _padded(W)
    nby, nbx = Hp // BLOCK, Wp // BLOCK
    s = torch.nn.functional.pad(score, (0, Wp - W, 0, Hp - H))
    blocks = (s.reshape(*lead, nby, BLOCK, nbx, BLOCK).transpose(-3, -2)
              .reshape(*lead, nby * nbx, BLOCK * BLOCK))

    cand_v, cand_i = [], []
    cur = blocks
    lane = torch.arange(BLOCK * BLOCK, device=score.device)
    for _ in range(CANDIDATES):
        val, idx = torch.max(cur, dim=-1)  # first maximum on ties
        cand_v.append(val)
        cand_i.append(idx)
        cur = torch.where(lane == idx[..., None], -torch.inf, cur)
    cv = torch.stack(cand_v, -1)  # [..., nb, 8]
    ci = torch.stack(cand_i, -1)

    blk = torch.arange(nby * nbx, device=score.device)[:, None]
    iy = (blk // nbx) * BLOCK + ci // BLOCK
    ix = (blk % nbx) * BLOCK + ci % BLOCK
    cv = torch.where((iy < H) & (ix < W), cv, 0.0)
    return cv, (iy * Wp + ix).to(torch.int32)


def keypoints_from_candidates(val: torch.Tensor, idx: torch.Tensor, k: int,
                              width: int) -> Keypoints:
    """Second stage of the two-stage top-k: the exact top-k of the
    candidates of :func:`block_candidates` (one optional batch axis) of a
    map ``width`` pixels wide, ties to the lower candidate index."""
    Wp = _padded(width)
    vals, sel = top_k_stable(val.flatten(-2), k)
    pick = idx.flatten(-2).gather(-1, sel)
    ys = (pick // Wp).to(val.dtype)
    xs = (pick % Wp).to(val.dtype)
    return Keypoints(xy=torch.stack([xs, ys], dim=-1), score=vals, valid=vals > 0.0)


def top_k_keypoints(score: torch.Tensor, k: int,
                    two_stage: bool | None = None) -> Keypoints:
    """Rank-select a fixed budget of keypoints from a dense [..., H, W]
    score map (no leading axis, or one batch axis).

    The two-stage path (default for H*W >= ``TWO_STAGE_MIN_PIXELS``) first
    reduces each 16x16 block to its top-8 candidates, then takes the exact
    top-k over the candidates; the single-stage path takes the top-k of the
    whole map. Ties go to the lower index in both, as in the reference.
    """
    H, W = score.shape[-2:]
    if two_stage is None:
        two_stage = H * W >= TWO_STAGE_MIN_PIXELS
    if two_stage:
        return keypoints_from_candidates(*block_candidates(score), k, W)
    vals, idx = top_k_stable(score.flatten(-2), k)
    ys = (idx // W).to(score.dtype)
    xs = (idx % W).to(score.dtype)
    return Keypoints(xy=torch.stack([xs, ys], dim=-1), score=vals,
                     valid=vals > 0.0)


def n_keypoints(H: int, W: int, max_keypoints: int) -> int:
    """The K of :func:`detect`'s result on [..., H, W] images: the budget,
    or fewer where the map (or the first stage's candidates) holds fewer
    entries."""
    if H * W >= TWO_STAGE_MIN_PIXELS:
        return min(max_keypoints, (_padded(H) // BLOCK) * (_padded(W) // BLOCK) * CANDIDATES)
    return min(max_keypoints, H * W)


def detect(img: torch.Tensor, threshold: float = 40.0, max_keypoints: int = 1024,
           nms: bool = True) -> Keypoints:
    """FAST detection with a fixed keypoint budget. img [H, W], or [B, H, W]
    for B frames at once (every field of the result then has a leading [B])."""
    s = fast_score_map(img, threshold)
    if nms:
        s = nms3(s)
    return top_k_keypoints(s, max_keypoints)
