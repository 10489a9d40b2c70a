"""Batched robust essential-matrix estimation: RANSAC and LMedS (port of
``epivo_tpu/ransac.py``).

``n_hyp`` minimal samples are drawn at once, solved with one batched
8-point solve (or one batched 5-point solve, ``geometry/fivepoint.py``,
up to 10 candidates per sample), scored against all N matches, and
reduced with an argmax. Both the match count N (padded, with ``mask``)
and the hypothesis count are static.

The reference draws its samples with ``jax.random.gumbel``, which torch
cannot reproduce. ``ransac_essential`` therefore takes the sample indices
as an optional tensor (``samples``); without it, the port draws its own
Gumbel-top-k samples from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from epivo_tpu_torch.geometry import essential, fivepoint

MIN_SAMPLE = 8  # 8-point minimal sample
SAMPLE_SIZE = {"8pt": MIN_SAMPLE, "5pt": 5}  # sample size per solver


class RansacResult(NamedTuple):
    """One pair's result; a batched call gives every field a leading [B]."""

    E: torch.Tensor  # [3, 3] best (refit) essential matrix
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int32
    best_score: torch.Tensor  # [] hypothesis score (count or -median)


def n_iterations(confidence: float, outlier_ratio: float,
                 sample_size: int = MIN_SAMPLE) -> int:
    """Classic RANSAC iteration count: log(1-conf)/log(1-(1-out)^m)."""
    w = (1.0 - outlier_ratio) ** sample_size
    if w <= 0:
        return 1 << 14
    return max(1, int(math.ceil(math.log(max(1e-12, 1.0 - confidence))
                                / math.log(1.0 - min(w, 1 - 1e-12)))))


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    broken toward the lower index, as ``jax.lax.top_k`` does (the order of
    ``torch.topk`` among ties is unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sample_indices(generator: torch.Generator, n_hyp: int, N: int,
                    mask: torch.Tensor | None, sample_size: int = MIN_SAMPLE,
                    device=None, lead: tuple = ()) -> torch.Tensor:
    """[*lead, n_hyp, sample_size] sample indices, approx. without
    replacement, valid-only: Gumbel-top-k over the validity mask [*lead, N].

    One draw of [*lead, n_hyp, N] uniforms, so a single leading lane draws
    exactly what the unbatched call draws from the same generator state.
    """
    u = torch.rand(tuple(lead) + (n_hyp, N), generator=generator,
                   device=generator.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    g = (-torch.log(-torch.log(u))).to(device)
    if mask is not None:
        g = torch.where(mask[..., None, :], g, -torch.inf)
    return top_k_stable(g, sample_size)[1]


def ransac_essential(
    generator: torch.Generator | None,
    p: torch.Tensor,
    p_t: torch.Tensor,
    n_hyp: int = 512,
    threshold: float = 1e-3,
    mask: torch.Tensor | None = None,
    method: str = "ransac",
    refit: bool = True,
    solver: str = "8pt",
    samples: torch.Tensor | None = None,
) -> RansacResult:
    """Robust essential-matrix estimation over batched hypotheses.

    Args:
      generator: draws the Gumbel-top-k samples; unused when ``samples``
        is given.
      p, p_t: [N, 3] normalized matches (padded; use ``mask``), or [B, N, 3]
        for B independent pairs (the reference's ``jax.vmap``); every
        output then has a leading [B].
      n_hyp: static hypothesis count.
      threshold: Sampson inlier threshold in squared normalized units.
      mask: [N] (or [B, N]) validity of the padded matches.
      method: "ransac" (inlier count) or "lmeds" (least median of squares).
      refit: refit E on the winning inlier set (guarded weighted 8-point).
      solver: "8pt" (projected 8-point minimal sample) or "5pt" (the
        Nister/Stewenius minimal solver, :func:`fivepoint.five_point`: each
        5-point sample yields up to 10 candidate E, all scored; it needs
        only 5 inliers per sample, which wins at high outlier ratios).
      samples: optional LongTensor [n_hyp, m] (or [B, n_hyp, m]) of match
        indices that replaces the random draw (how the tests feed the
        reference's samples in); m is the solver's sample size
        (``SAMPLE_SIZE``: 8 or 5).

    Every lane picks its own winner (first maximum over all candidates on
    ties), its own LMedS median and its own guarded refit, with no host
    sync.
    """
    if solver not in SAMPLE_SIZE:
        raise ValueError(f"unknown solver {solver!r}")
    if method not in ("ransac", "lmeds"):
        raise ValueError(f"unknown method {method!r}")
    if p.dim() == 2:
        out = ransac_essential(
            generator, p[None], p_t[None], n_hyp, threshold,
            None if mask is None else mask[None], method, refit, solver,
            None if samples is None else samples[None])
        return RansacResult(*(f[0] for f in out))

    B, N = p.shape[:2]
    valid = mask if mask is not None else torch.ones((B, N), dtype=torch.bool,
                                                     device=p.device)
    n_valid = torch.sum(valid, dim=-1)  # [B]

    m = SAMPLE_SIZE[solver]
    if samples is None:
        if generator is None:
            raise ValueError("ransac_essential needs a generator or samples")
        idx = _sample_indices(generator, n_hyp, N, mask, m, device=p.device, lead=(B,))
    else:
        idx = samples.to(device=p.device, dtype=torch.int64)
        if idx.shape != (B, n_hyp, m):
            raise ValueError(f"samples must be [{B}, {n_hyp}, {m}], "
                             f"got {tuple(idx.shape)}")
    lane = torch.arange(B, device=p.device)
    p_s, p_ts = p[lane[:, None, None], idx], p_t[lane[:, None, None], idx]
    if solver == "5pt":
        Es_c, hyp_ok = fivepoint.five_point(p_s.reshape(B * n_hyp, m, 3),
                                            p_ts.reshape(B * n_hyp, m, 3))
        Es = Es_c.reshape(B, n_hyp * 10, 3, 3)  # [B, H, 3, 3], H = n_hyp * 10
        hyp_ok = hyp_ok.reshape(B, n_hyp * 10)
    else:
        # Hypotheses are projected to the essential manifold (regularizes
        # near-degenerate minimal samples).
        Es = essential.eight_point(p_s, p_ts, project=True)  # [B, H, 3, 3]
        hyp_ok = None
    H = Es.shape[1]

    err = essential.sampson_error(Es, p[:, None], p_t[:, None])  # [B, H, N]
    ok = valid[:, None, :] if hyp_ok is None else valid[:, None, :] & hyp_ok[..., None]
    err = torch.where(ok, err, torch.inf)

    if method == "lmeds":
        # Median over each lane's valid entries: sort and take the entry at
        # that lane's n_valid // 2.
        err_sorted = torch.sort(err, dim=-1).values
        mid = torch.clamp(n_valid // 2, 0, N - 1)
        med = torch.gather(err_sorted, -1, mid[:, None, None].expand(B, H, 1))[..., 0]
        score = -med  # [B, H]
        best = torch.argmax(score, dim=-1)  # [B]
        best_med = med[lane, best]
        # OpenCV-style robust sigma from the best median:
        # 2.5 * 1.4826 * (1 + 5/(n-8)) * sqrt(med); the gate is err < sigma^2,
        # floored at the caller's threshold.
        sigma = 2.5 * 1.4826 * (1.0 + 5.0 / torch.clamp(n_valid - 8, min=1)) \
            * torch.sqrt(torch.clamp(best_med, min=1e-18))
        thr = torch.clamp(sigma * sigma, min=threshold).to(p.dtype)
    else:
        inl = (err < threshold) & valid[:, None, :]
        score = torch.sum(inl, dim=-1).to(p.dtype)
        # First maximum on ties, as jnp.argmax.
        best = torch.argmax(score, dim=-1)
        thr = torch.full((B,), threshold, dtype=p.dtype, device=p.device)

    E_best = Es[lane, best]  # [B, 3, 3]
    inliers = (essential.sampson_error(E_best, p, p_t) < thr[:, None]) & valid
    if refit:
        # Guarded refit: keep it only with >= 8 support points and no loss
        # of inliers versus the winning hypothesis.
        w = inliers.to(p.dtype)
        E_refit = essential.eight_point(p, p_t, weights=w)
        inl_refit = (essential.sampson_error(E_refit, p, p_t) < thr[:, None]) & valid
        n_inl = torch.sum(inliers, dim=-1)
        use_refit = (n_inl >= MIN_SAMPLE) & (torch.sum(inl_refit, dim=-1) >= n_inl)
        E_final = torch.where(use_refit[:, None, None], E_refit, E_best)
        inliers = torch.where(use_refit[:, None], inl_refit, inliers)
    else:
        E_final = E_best

    return RansacResult(
        E=E_final,
        inliers=inliers,
        n_inliers=torch.sum(inliers, dim=-1).to(torch.int32),
        best_score=score[lane, best],
    )
