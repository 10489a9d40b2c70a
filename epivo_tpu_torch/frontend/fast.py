"""FAST-9/16 corner detection with a fixed keypoint budget (port of
``epivo_tpu/frontend/fast.py``).

The dense score map with fused 3x3 NMS runs as the CUDA kernel
``csrc/fast.cu`` on a CUDA tensor (:func:`fast_score_map_kernel`), and as
the plain :func:`fast_score_map` + :func:`nms3` on a CPU tensor; both are
bit-identical to the reference. The score map is reduced to the budget by
the reference's two-stage top-k, with ties broken toward the lower index
as ``jax.lax.top_k`` does, so the keypoint list matches in content and
order.
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

# Launches of the CUDA kernel made by this process (never by the plain path).
KERNEL_LAUNCHES = 0


class Keypoints(NamedTuple):
    """Fixed-budget keypoint set."""

    xy: torch.Tensor  # [K, 2] float (x, y) pixel coordinates
    score: torch.Tensor  # [K] detector response
    valid: torch.Tensor  # [K] bool


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


def fast_score_map_kernel(img: torch.Tensor, threshold: float,
                          nms: bool = True) -> torch.Tensor:
    """FAST score map (3x3-NMS'd when ``nms``) by the CUDA kernel.

    img: CUDA float32 [H, W] or [B, H, W], contiguous. Bit-identical to
    ``nms3(fast_score_map(img, threshold))`` (or the score map alone).
    """
    global KERNEL_LAUNCHES
    if not img.is_cuda:
        raise ValueError("fast_score_map_kernel needs a CUDA tensor")
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError(f"expected float32 [H, W] or [B, H, W], got "
                         f"{img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("fast_score_map_kernel needs a contiguous image")
    x = img if img.dim() == 3 else img[None]
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


def top_k_keypoints(score: torch.Tensor, k: int,
                    two_stage: bool | None = None) -> Keypoints:
    """Rank-select a fixed budget of keypoints from a dense [H, W] score map.

    The two-stage path (default for H*W >= 65536) first reduces each 16x16
    block to its top-8 candidates, then takes the exact top-k over the
    candidates; the single-stage path takes the top-k of the whole map.
    Ties go to the lower index in both, as in the reference.
    """
    H, W = score.shape
    if two_stage is None:
        two_stage = H * W >= 1 << 16
    if not two_stage:
        vals, idx = top_k_stable(score.reshape(-1), k)
        ys = (idx // W).to(score.dtype)
        xs = (idx % W).to(score.dtype)
        return Keypoints(xy=torch.stack([xs, ys], dim=-1), score=vals,
                         valid=vals > 0.0)

    B, M = 16, 8  # block edge, candidates per block
    Hp = ((H + B - 1) // B) * B
    Wp = ((W + B - 1) // B) * B
    s = torch.nn.functional.pad(score, (0, Wp - W, 0, Hp - H))
    nb = (Hp // B) * (Wp // B)
    blocks = s.reshape(Hp // B, B, Wp // B, B).permute(0, 2, 1, 3).reshape(nb, B * B)

    cand_v, cand_i = [], []
    cur = blocks
    lane = torch.arange(B * B, device=score.device)[None, :]
    for _ in range(M):
        val, idx = torch.max(cur, dim=-1)  # first maximum on ties
        cand_v.append(val)
        cand_i.append(idx)
        cur = torch.where(lane == idx[:, None], -torch.inf, cur)
    cv = torch.stack(cand_v, -1)  # [nb, M]
    ci = torch.stack(cand_i, -1)

    blk = torch.arange(nb, device=score.device)
    iy = ((blk // (Wp // B)) * B)[:, None] + ci // B
    ix = ((blk % (Wp // B)) * B)[:, None] + ci % B
    cv = torch.where((iy < H) & (ix < W), cv, 0.0)

    vals, sel = top_k_stable(cv.reshape(-1), k)
    ys = iy.reshape(-1)[sel].to(score.dtype)
    xs = ix.reshape(-1)[sel].to(score.dtype)
    return Keypoints(xy=torch.stack([xs, ys], dim=-1), score=vals,
                     valid=vals > 0.0)


def detect(img: torch.Tensor, threshold: float = 40.0, max_keypoints: int = 1024,
           nms: bool = True, use_kernel: bool | None = None) -> Keypoints:
    """FAST detection with a fixed keypoint budget. img [H, W].

    ``use_kernel=None`` runs the CUDA kernel for a CUDA tensor and the plain
    version for a CPU tensor; ``True`` on a CPU tensor raises.
    """
    if kernel_wanted(img, use_kernel):
        s = fast_score_map_kernel(img.contiguous(), threshold, nms=nms)
    else:
        s = fast_score_map(img, threshold)
        if nms:
            s = nms3(s)
    return top_k_keypoints(s, max_keypoints)
