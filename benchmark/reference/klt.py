"""Pyramidal Lucas-Kanade optical flow, batched over keypoints: a frozen
copy of the port's plain path (``epivo_tpu_torch/frontend/klt.py``,
``track_level_composed`` with every stage in torch), the oracle of its
``klt_level`` kernel.

Per pyramid level, each keypoint gets one integer-aligned S x S window
(S = win + 2 * margin + 1) from the source and one from the target image;
the template and its Scharr gradients are sampled from the source window,
and the LK iterations run inside the target window. Window origins clamp
at image borders, and the effective template centre is tracked explicitly
so clamping never biases the flow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import image as imops


class FlowResult(NamedTuple):
    xy: torch.Tensor  # [..., K, 2] tracked positions in the target image
    status: torch.Tensor  # [..., K] bool
    err: torch.Tensor  # [..., K] mean absolute patch residual


# ---------------------------------------------------------------------------
# Window extraction
# ---------------------------------------------------------------------------


def extract_windows_plain(img: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                          size: int) -> torch.Tensor:
    """[B, H, W] image, [B, K] integer origins -> [B, K, size, size] windows
    ``img[b, oy:oy+size, ox:ox+size]`` (a gather). Origins
    are first clamped to [0, H - size] x [0, W - size], as the reference
    clips them and ``jax.lax.dynamic_slice`` clamps them."""
    H, W = img.shape[-2:]
    r = torch.arange(size, device=img.device)
    rows = (oy.long().clamp(0, H - size)[..., None] + r)[..., :, None]  # [B, K, S, 1]
    cols = (ox.long().clamp(0, W - size)[..., None] + r)[..., None, :]  # [B, K, 1, S]
    b = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[b, rows, cols]


def _extract_windows(img: torch.Tensor, centers: torch.Tensor, size: int):
    """Integer-aligned size x size windows around ``centers`` [..., K, 2] of
    [..., H, W] images (no leading axis, or one batch axis). Returns
    (windows [..., K, size, size], origins [..., K, 2] (x, y)): the actual
    clamped top-left corners, which callers must use."""
    H, W = img.shape[-2:]
    r = size // 2
    c_int = torch.round(centers).to(torch.int32)  # half to even, as jnp.round
    ox = torch.clamp(c_int[..., 0] - r, 0, W - size)
    oy = torch.clamp(c_int[..., 1] - r, 0, H - size)
    if img.dim() == 2:
        wins = extract_windows_plain(img[None], oy[None], ox[None], size)[0]
    else:
        wins = extract_windows_plain(img, oy, ox, size)
    return wins, torch.stack([ox, oy], dim=-1).to(img.dtype)


# Scharr gradients over a stack of windows [K, S, S] (edge padded): the
# image operator works on any leading axes.
_grad_batch = imops.scharr_gradients


def _sample_patches(wins: torch.Tensor, q: torch.Tensor, win: int) -> torch.Tensor:
    """Bilinear win x win patches from [K, S, S] windows at top-left corners
    q [K, 2] (x, y): a direct gather of (win + 1)^2 taps per keypoint and
    the reference's four-tap blend, in its order of terms."""
    K, S, _ = wins.shape
    hi = S - win - 1e-3
    qx = torch.clamp(q[:, 0], 0.0, hi)
    qy = torch.clamp(q[:, 1], 0.0, hi)
    flx, fly = torch.floor(qx), torch.floor(qy)
    fx = (qx - flx)[:, None, None]
    fy = (qy - fly)[:, None, None]
    r = torch.arange(win + 1, device=wins.device)
    rows = (fly.long()[:, None] + r)[:, :, None]  # [K, win+1, 1]
    cols = (flx.long()[:, None] + r)[:, None, :]  # [K, 1, win+1]
    kk = torch.arange(K, device=wins.device)[:, None, None]
    acc = wins[kk, rows, cols]  # [K, win+1, win+1]
    return (
        acc[:, :win, :win] * (1 - fx) * (1 - fy)
        + acc[:, :win, 1:] * fx * (1 - fy)
        + acc[:, 1:, :win] * (1 - fx) * fy
        + acc[:, 1:, 1:] * fx * fy
    )


# ---------------------------------------------------------------------------
# LK iterations
# ---------------------------------------------------------------------------


def lk_iterate_plain(tgt_wins: torch.Tensor, T: torch.Tensor, Ix: torch.Tensor,
                     Iy: torch.Tensor, q0: torch.Tensor, win: int, iters: int,
                     eps: float):
    """``iters`` LK steps for all keypoints (plain version).

    tgt_wins [K, S, S]; T/Ix/Iy [K, win, win] (template and gradients
    sampled at the template position); q0 [K, 2] top-left corners (x, y)
    in window coordinates. Returns (q [K, 2], err [K] = mean |P - T|).
    """
    S = tgt_wins.shape[-1]
    hi = S - win - 1 - 1e-3
    Gxx = torch.sum(Ix * Ix, dim=(1, 2))
    Gxy = torch.sum(Ix * Iy, dim=(1, 2))
    Gyy = torch.sum(Iy * Iy, dim=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)

    q = torch.clamp(q0, 0.0, hi)
    done = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for _ in range(iters):
        dI = _sample_patches(tgt_wins, q, win) - T
        bx = torch.sum(dI * Ix, dim=(1, 2))
        by = torch.sum(dI * Iy, dim=(1, 2))
        dx = -(Gyy * bx - Gxy * by) * inv_det
        dy = -(-Gxy * bx + Gxx * by) * inv_det
        step = torch.stack([dx, dy], dim=-1)
        q = torch.where(done[:, None], q, torch.clamp(q + step, 0.0, hi))
        done = done | (torch.linalg.norm(step, dim=-1) < eps)
    err = torch.mean(torch.abs(_sample_patches(tgt_wins, q, win) - T), dim=(1, 2))
    return q, err


# ---------------------------------------------------------------------------
# One level and the pyramid
# ---------------------------------------------------------------------------


def _template(src: torch.Tensor, pt_src: torch.Tensor, win: int, S: int):
    """Template T and gradients Ix/Iy [..., K, win, win] at ``pt_src``
    [..., K, 2] from one source window each, and the effective
    (clamp-aware) template centres c_eff [..., K, 2]."""
    hi = S - win - 1 - 1e-3
    src_wins, o_s = _extract_windows(src, pt_src, S)
    gx, gy = _grad_batch(src_wins)
    q_s = torch.clamp(pt_src - o_s - (win - 1) / 2.0, 0.0, hi)
    c_eff = o_s + q_s + (win - 1) / 2.0
    q_flat, lead = q_s.reshape(-1, 2), q_s.shape[:-1]
    T, Ix, Iy = (_sample_patches(w.reshape(-1, S, S), q_flat, win).reshape(
        *lead, win, win) for w in (src_wins, gx, gy))
    return T, Ix, Iy, c_eff


def _target(tgt: torch.Tensor, g: torch.Tensor, win: int, S: int):
    """Target windows [..., K, S, S] around the guesses g [..., K, 2], their
    origins [..., K, 2] and the starting corners q0 [..., K, 2] inside them."""
    hi = S - win - 1 - 1e-3
    tgt_wins, o_t = _extract_windows(tgt, g, S)
    q0 = torch.clamp(g - o_t - (win - 1) / 2.0, 0.0, hi)
    return tgt_wins, o_t, q0


def _min_eigenvalue(Ix: torch.Tensor, Iy: torch.Tensor) -> torch.Tensor:
    """Smaller eigenvalue of G = sum [Ix^2, IxIy; IxIy, Iy^2] over each
    [..., win, win] patch."""
    Gxx = torch.sum(Ix * Ix, dim=(-2, -1))
    Gxy = torch.sum(Ix * Iy, dim=(-2, -1))
    Gyy = torch.sum(Iy * Iy, dim=(-2, -1))
    det = Gxx * Gyy - Gxy * Gxy
    trace = Gxx + Gyy
    return (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det, min=0.0))) / 2.0


def track_level_composed(src, tgt, pt_src, guess, win: int, margin: int,
                         iters: int, eps: float, min_eig: float,
                         n_chunks: int = 2):
    """One pyramid level as a composition: window extraction (B2), Scharr,
    template sampling and the LK iterations (B3) in torch around them.

    src/tgt [..., H, W] with no leading axis or one batch axis; pt_src /
    guess [..., K, 2] positions at this level's scale. Returns (new_guess
    [..., K, 2], ok [..., K], err [..., K]). The target window is
    re-centred between ``n_chunks`` chunks of iterations.
    """
    S = win + 2 * margin + 1
    T, Ix, Iy, c_eff = _template(src, pt_src, win, S)
    ok = _min_eigenvalue(Ix, Iy) / (win * win) > min_eig

    # B3 takes keypoints on one axis: fold any batch axis into it.
    flat = lambda a, *tail: a.reshape(-1, *tail)
    chunk_iters = max(1, iters // n_chunks)
    g = guess + (c_eff - pt_src)  # track the effective template centre
    err = None
    for _ in range(n_chunks):
        tgt_wins, o_t, q0 = _target(tgt, g, win, S)
        q_fin, err = lk_iterate_plain(flat(tgt_wins, S, S), flat(T, win, win),
                                      flat(Ix, win, win), flat(Iy, win, win),
                                      flat(q0, 2), win, chunk_iters, eps)
        g = q_fin.reshape(g.shape) + o_t + (win - 1) / 2.0
    # Position of pt_src's content = pt_src + measured template flow.
    return pt_src + (g - c_eff), ok, err.reshape(ok.shape)


def default_margins(levels: int) -> list[int]:
    """Margin 12 at the top level (which absorbs the full motion), 6 below."""
    margin = [6] * levels
    margin[levels - 1] = 12
    return margin


def track(
    src: torch.Tensor,
    tgt: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor | None = None,
    win: int = 21,
    levels: int = 4,
    iters: int = 30,
    eps: float = 0.01,
    min_eig: float = 1e-4,
    max_err: float = 1e9,
    margin: int | tuple[int, ...] | list[int] | None = None,
    n_chunks: int = 1,
    levels_out: list | None = None,
) -> FlowResult:
    """Track points from the src to the tgt image. src, tgt [H, W] with pts
    [K, 2] (x, y) pixels and valid [K]; or src, tgt [B, H, W] with pts
    [B, K, 2] and valid [B, K] for B pairs at once.

    OpenCV-default-equivalent configuration: winSize 21, 4 levels, eps
    0.01. ``margin`` bounds the per-chunk displacement per level: an int or
    a per-level sequence (entry 0 = full resolution); the default is 12 at
    the top level and 6 below.

    ``levels_out``, when given, receives one (src,
    tgt, pt_src, guess) per level from the top down: the inputs a level
    launch of the program reads, for the yardstick's work count.
    """
    if margin is None:
        margin = default_margins(levels)
    elif isinstance(margin, int):
        margin = [margin] * levels
    margin = list(margin)
    if len(margin) != levels:
        raise ValueError(f"need {levels} margins, got {len(margin)}")

    pyr_s = imops.build_pyramid(src, levels)
    pyr_t = imops.build_pyramid(tgt, levels)

    # Small top levels must still fit the window: pad bottom/right with
    # edge replication (coordinates are unaffected).
    S_max = win + 2 * max(margin) + 1

    def pad_to_window(im):
        ph = max(0, S_max - im.shape[-2])
        pw = max(0, S_max - im.shape[-1])
        if ph or pw:
            im = imops.edge_pad(im, 0, ph, 0, pw)
        return im

    pyr_s = [pad_to_window(im) for im in pyr_s]
    pyr_t = [pad_to_window(im) for im in pyr_t]

    g = pts / 2.0 ** (levels - 1)
    ok = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    err = torch.zeros(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    for lvl in range(levels - 1, -1, -1):
        p_lvl = pts / 2.0**lvl
        if levels_out is not None:
            levels_out.append((pyr_s[lvl], pyr_t[lvl], p_lvl, g))
        g, ok_lvl, err = track_level_composed(
            pyr_s[lvl], pyr_t[lvl], p_lvl, g, win, margin[lvl], iters, eps,
            min_eig, n_chunks=n_chunks,
        )
        ok = ok & ok_lvl
        if lvl > 0:
            g = g * 2.0

    H, W = tgt.shape[-2:]
    gx, gy = g[..., 0], g[..., 1]
    inb = (gx >= 0) & (gx <= W - 1) & (gy >= 0) & (gy <= H - 1)
    status = ok & inb & (err < max_err)
    if valid is not None:
        status = status & valid
    return FlowResult(xy=g, status=status, err=err)
