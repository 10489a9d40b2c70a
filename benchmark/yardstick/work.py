"""The work the two frontend kernels need, and the least time it takes on
the card: a frozen copy of ``chip_smoke.py``'s ``bound``, ``fast_work``,
``cand_work``, ``lk_steps``, ``level_lk`` and ``level_work``, computed with
the reference's plain code.

Bytes count each input byte read once and each output byte written once,
whatever a kernel reads again.
``fast_cand`` reads its frames [B, H, W] and writes 8 candidates (value
and index) per 16x16 block; one ``klt_level`` launch reads both images of
its level, the points and the guesses, and writes the new guesses, the ok
flags and the errors. Operations count what these inputs need: the
compass test on every interior pixel, the full score on the sides that
pass it, NMS and the selection rounds; and the LK steps that each
keypoint takes before it freezes (the data-dependent part), not the most
a kernel could run.
"""

from __future__ import annotations

import torch

from benchmark.reference import fast, klt

# H100 SXM data sheet: HBM3 bytes/s, and float32 operations/s outside the
# tensor cores (an FMA counting as two), at the full 700 W power limit.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

# Float operations per pixel, counted from the kernels' arithmetic.
SAMPLE_OPS = 11  # four-tap bilinear blend: 8 products, 3 sums
LK_STEP_OPS = SAMPLE_OPS + 5  # residual, and 2 multiply-adds into b
G_OPS = 6  # 3 products, 3 sums into G
ERR_OPS = SAMPLE_OPS + 2  # residual, |.| summed
TAP3_OPS = 6  # one 3-tap Scharr pass
# The compass test: the neighbouring pairs' min and max (14), two centre
# subtractions, two comparisons.
COMPASS_OPS = 14 + 2 + 2
# One side of the full score: shared partial minima (48), arc minima (16),
# the best-arc tree (15), the centre, the threshold.
ARC_OPS = 48 + 16 + 15 + 1 + 1
NMS_SEP_OPS = 6  # with row maxima shared between rows
SELECT_OPS = 2 * 256  # per selection round of a block: max reduction, ballots


def bound_s(nbytes: float, nops: float) -> float:
    """Least time in seconds for moving ``nbytes`` and doing ``nops``."""
    return max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S)


def fast_work(img: torch.Tensor, t: float) -> tuple[int, int]:
    """(interior pixels, compass-test sides passed summed over them) of one
    frame: the data-dependent part of the FAST op count."""
    H, W = img.shape
    c = img[3:H - 3, 3:W - 3]
    d = [img[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx] - c
         for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    pairs = ((0, 1), (1, 2), (2, 3), (3, 0))
    bright = torch.stack([(d[a] > t) & (d[b] > t) for a, b in pairs]).any(0)
    dark = torch.stack([(d[a] < -t) & (d[b] < -t) for a, b in pairs]).any(0)
    return c.numel(), int(bright.sum()) + int(dark.sum())


def cand_work(imgs: torch.Tensor, thr: float) -> tuple[int, int]:
    """(bytes, operations) of one ``fast_cand`` launch on frames [B, H, W]
    at threshold ``thr``."""
    B, H, W = imgs.shape
    n_int = n_sides = rounds = 0
    for img in imgs:
        a, b = fast_work(img, thr)
        pv, _ = fast.block_candidates(fast.nms3(fast.fast_score_map(img, thr)))
        n_int, n_sides = n_int + a, n_sides + b
        rounds += int((1 + (pv[:, 1:] != pv[:, :-1]).sum(-1)).sum())
    nb = pv.shape[0]
    score_ops = n_int * COMPASS_OPS + n_sides * ARC_OPS
    nbytes = B * H * W * 4 + B * nb * 8 * (4 + 4)
    return nbytes, score_ops + B * H * W * NMS_SEP_OPS + rounds * SELECT_OPS


def lk_steps(tgt_wins, T, Ix, Iy, q0, win: int, iters: int, eps: float) -> int:
    """The keypoint-steps the LK loop runs on these inputs before each
    keypoint freezes (``klt.lk_iterate_plain``'s rule)."""
    S = tgt_wins.shape[-1]
    hi = S - win - 1 - 1e-3
    Gxx, Gxy, Gyy = ((a * b).sum((1, 2)) for a, b in ((Ix, Ix), (Ix, Iy), (Iy, Iy)))
    det = Gxx * Gyy - Gxy * Gxy
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    q = q0.clamp(0.0, hi)
    done = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    steps = 0
    for _ in range(iters):
        steps += int((~done).sum())
        dI = klt._sample_patches(tgt_wins, q, win) - T
        bx, by = (dI * Ix).sum((1, 2)), (dI * Iy).sum((1, 2))
        step = torch.stack([-(Gyy * bx - Gxy * by) * inv_det,
                            -(-Gxy * bx + Gxx * by) * inv_det], -1)
        norm = torch.linalg.norm(step, dim=-1)
        q = torch.where(done[:, None], q, (q + step).clamp(0.0, hi))
        done = done | (norm < eps)
    return steps


def level_work(src, tgt, pts, guess, win: int, margin: int, iters: int,
               eps: float = 0.01) -> tuple[int, int]:
    """(bytes, operations) of one ``klt_level`` launch on one level's
    images [B, H, W], points and guesses [B, K, 2] (one chunk of ``iters``
    steps, the step's setting)."""
    B, Hl, Wl = src.shape
    K, n = pts.shape[1], win * win
    S = win + 2 * margin + 1
    T, Ix, Iy, c_eff = klt._template(src, pts, win, S)
    tgt_wins, _, q0 = klt._target(tgt, guess + (c_eff - pts), win, S)
    steps = lk_steps(tgt_wins.reshape(-1, S, S), T.reshape(-1, win, win),
                     Ix.reshape(-1, win, win), Iy.reshape(-1, win, win),
                     q0.reshape(-1, 2), win, iters, eps)
    scharr = ((win + 3) * (win + 1) + (win + 1) ** 2) * 2 * TAP3_OPS
    nbytes = 2 * B * Hl * Wl * 4 + 2 * B * K * 2 * 4 + B * K * (2 * 4 + 1 + 4)
    nops = (B * K * (scharr + n * (3 * SAMPLE_OPS + G_OPS + ERR_OPS))
            + steps * n * LK_STEP_OPS)
    return nbytes, nops

