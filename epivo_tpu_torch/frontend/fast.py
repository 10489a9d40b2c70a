"""FAST-9/16 corner detection with a fixed keypoint budget (port of
``epivo_tpu/frontend/fast.py``).

The budget is taken by the reference's two-stage top-k on maps of at least
``TWO_STAGE_MIN_PIXELS`` pixels: the first stage keeps the best 8 of each
16x16 block (:func:`block_candidates`), the second takes the exact top-k of
those candidates (:func:`keypoints_from_candidates`); smaller maps take the
top-k of the whole map. Ties go to the lower index, as ``jax.lax.top_k``
breaks them, so the keypoint list matches in content and order.

On a CUDA tensor, :func:`detect` runs the CUDA kernels of ``csrc/fast.cu``:
on a two-stage map the fused :func:`fast_candidates_kernel` (score, 3x3 NMS
and the first stage in one launch; the dense map never reaches device
memory), else the dense :func:`fast_score_map_kernel`. On a CPU tensor it
runs the plain :func:`fast_score_map` + :func:`nms3` and the plain stages.
Kernels and plain versions are bit-identical to each other and to the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from epivo_tpu_torch import _kernels
from epivo_tpu_torch._device import kernel_wanted
from epivo_tpu_torch.ransac import top_k_stable

# Bresenham circle of radius 3: 16 (dy, dx) offsets clockwise from the top.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # FAST-9: at least 9 contiguous circle pixels all brighter/darker

# Maps of at least this many pixels take the two-stage top-k.
TWO_STAGE_MIN_PIXELS = 1 << 16
BLOCK, CANDIDATES = 16, 8  # first stage: block edge, candidates per block

# Launches of the CUDA kernels made by this process (never by the plain path):
# the dense score map, and the fused candidate kernel.
KERNEL_LAUNCHES = 0
CAND_LAUNCHES = 0


class Keypoints(NamedTuple):
    """Fixed-budget keypoint set."""

    xy: torch.Tensor  # [..., K, 2] float (x, y) pixel coordinates
    score: torch.Tensor  # [..., K] detector response
    valid: torch.Tensor  # [..., K] bool


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9/16 corner response (plain version). img [..., H, W];
    returns scores of the same shape, 0 for non-corners and in the 3-pixel
    border.

    Score: max over the 16 arcs of 9 ring pixels of the arc's min
    difference (bright) or minus its max difference (dark).
    """
    H, W = img.shape[-2:]
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1))
                        for dy, dx in CIRCLE])  # [16, ..., H, W]
    diff = ring - img[None]
    idx = (torch.arange(16)[:, None] + torch.arange(ARC)[None, :]) % 16  # [16, 9]
    arc_vals = diff[idx.to(img.device)]  # [16, 9, ..., H, W]
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
    """3x3 non-maximum suppression (plain version): keep a score that is
    >= all 8 neighbours (outside the image counts as -inf)."""
    H, W = score.shape[-2:]
    p = torch.nn.functional.pad(score, (1, 1, 1, 1), value=-torch.inf)
    neigh = torch.stack([
        p[..., 1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1) if not (dy == 0 and dx == 0)
    ])
    keep = score >= torch.amax(neigh, dim=0)
    return torch.where(keep, score, 0.0)


def _check_image(img: torch.Tensor, name: str) -> torch.Tensor:
    """A kernel wrapper's argument check; returns the image as [B, H, W]."""
    if not img.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"expected float32 [H, W] or [B, H, W], got "
                         f"{img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError(f"{name} needs a contiguous image")
    return img if img.dim() == 3 else img[None]


def fast_score_map_kernel(img: torch.Tensor, threshold: float,
                          nms: bool = True) -> torch.Tensor:
    """FAST score map (3x3-NMS'd when ``nms``) by the CUDA kernel.

    img: CUDA float32 [H, W] or [B, H, W], contiguous. Bit-identical to
    ``nms3(fast_score_map(img, threshold))`` (or the score map alone).
    """
    global KERNEL_LAUNCHES
    x = _check_image(img, "fast_score_map_kernel")
    B, H, W = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out.reshape(img.shape)
    lib = _kernels.lib()
    status = lib.epivo_fast_score(x.data_ptr(), out.data_ptr(), B, H, W,
                                  float(threshold), int(bool(nms)),
                                  _kernels.stream_of(x))
    _kernels.check(status, "epivo_fast_score")
    KERNEL_LAUNCHES += 1
    return out.reshape(img.shape)


def _padded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def fast_candidates_kernel(img: torch.Tensor, threshold: float, nms: bool = True):
    """First-stage candidates of the FAST map by the fused CUDA kernel.

    img: CUDA float32 [H, W] or [B, H, W], contiguous. Returns (val, idx)
    as :func:`block_candidates` does for ``nms3(fast_score_map(img,
    threshold))`` (or the score map alone), bit for bit on finite images.
    Launches on the current stream and makes no host sync.
    """
    global CAND_LAUNCHES
    x = _check_image(img, "fast_candidates_kernel")
    B, H, W = x.shape
    if _padded(H) * _padded(W) >= 1 << 31:
        raise ValueError(f"a {H}x{W} image overflows the int32 candidate index")
    nb = (_padded(H) // BLOCK) * (_padded(W) // BLOCK)
    val = torch.empty((B, nb, CANDIDATES), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, nb, CANDIDATES), dtype=torch.int32, device=x.device)
    if val.numel():
        status = _kernels.lib().epivo_fast_candidates(
            x.data_ptr(), val.data_ptr(), idx.data_ptr(), B, H, W, float(threshold),
            int(bool(nms)), _kernels.stream_of(x))
        _kernels.check(status, "epivo_fast_candidates")
        CAND_LAUNCHES += 1
    if img.dim() == 2:
        return val[0], idx[0]
    return val, idx


def block_candidates(score: torch.Tensor):
    """First stage of the two-stage top-k (plain version).

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


def detect(img: torch.Tensor, threshold: float = 40.0, max_keypoints: int = 1024,
           nms: bool = True, use_kernel: bool | None = None) -> Keypoints:
    """FAST detection with a fixed keypoint budget. img [H, W], or [B, H, W]
    for B frames at once (every field of the result then has a leading [B]).

    ``use_kernel=None`` runs the CUDA kernels for a CUDA tensor and the
    plain version for a CPU tensor; ``True`` on a CPU tensor raises. On the
    kernel path a two-stage map goes through one launch of the fused
    candidate kernel, whatever B is, and the torch second stage, with no
    host sync.
    """
    if kernel_wanted(img, use_kernel):
        H, W = img.shape[-2:]
        if H * W >= TWO_STAGE_MIN_PIXELS:
            val, idx = fast_candidates_kernel(img.contiguous(), threshold, nms=nms)
            return keypoints_from_candidates(val, idx, max_keypoints, W)
        s = fast_score_map_kernel(img.contiguous(), threshold, nms=nms)
    else:
        s = fast_score_map(img, threshold)
        if nms:
            s = nms3(s)
    return top_k_keypoints(s, max_keypoints)
