"""Batched robust essential-matrix estimation: RANSAC and LMedS (port of
``epivo_tpu/ransac.py``).

``n_hyp`` minimal samples are drawn at once, solved with one batched
8-point solve, scored against all N matches, and reduced with an argmax.
Both the match count N (padded, with ``mask``) and the hypothesis count
are static.

The reference draws its samples with ``jax.random.gumbel``, which torch
cannot reproduce. ``ransac_essential`` therefore takes the sample indices
as an optional tensor (``samples``); without it, the port draws its own
Gumbel-top-k samples from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from epivo_tpu_torch.geometry import essential

MIN_SAMPLE = 8  # 8-point minimal sample


class RansacResult(NamedTuple):
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
                    device=None) -> torch.Tensor:
    """[n_hyp, sample_size] sample indices, approx. without replacement,
    valid-only: Gumbel-top-k over the validity mask."""
    u = torch.rand((n_hyp, N), generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    g = (-torch.log(-torch.log(u))).to(device)
    if mask is not None:
        g = torch.where(mask[None, :], g, -torch.inf)
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
      p, p_t: [N, 3] normalized matches (padded; use ``mask``).
      n_hyp: static hypothesis count.
      threshold: Sampson inlier threshold in squared normalized units.
      mask: [N] validity of the padded matches.
      method: "ransac" (inlier count) or "lmeds" (least median of squares).
      refit: refit E on the winning inlier set (guarded weighted 8-point).
      solver: "8pt" only; the 5-point solver is not ported yet.
      samples: optional LongTensor [n_hyp, 8] of match indices that replaces
        the random draw (how the tests feed the reference's samples in).
    """
    if solver == "5pt":
        raise NotImplementedError(
            "solver='5pt' is not ported yet (ROADMAP.md, queue A item 11: "
            "the 5-point solver, geometry/fivepoint.py)"
        )
    if solver != "8pt":
        raise ValueError(f"unknown solver {solver!r}")
    if method not in ("ransac", "lmeds"):
        raise ValueError(f"unknown method {method!r}")
    N = p.shape[0]
    valid = mask if mask is not None else torch.ones(N, dtype=torch.bool,
                                                     device=p.device)
    n_valid = torch.sum(valid)

    if samples is None:
        if generator is None:
            raise ValueError("ransac_essential needs a generator or samples")
        idx = _sample_indices(generator, n_hyp, N, mask, device=p.device)
    else:
        idx = samples.to(device=p.device, dtype=torch.int64)
        if idx.shape != (n_hyp, MIN_SAMPLE):
            raise ValueError(
                f"samples must be [{n_hyp}, {MIN_SAMPLE}], got {tuple(idx.shape)}")
    # Hypotheses are projected to the essential manifold (regularizes
    # near-degenerate minimal samples).
    Es = essential.eight_point(p[idx], p_t[idx], project=True)  # [n_hyp, 3, 3]

    err = essential.sampson_error(Es, p[None], p_t[None])  # [H, N]
    err = torch.where(valid[None, :], err, torch.inf)

    if method == "lmeds":
        # Median over valid entries: sort and index at n_valid // 2.
        err_sorted = torch.sort(err, dim=-1).values
        mid = torch.clamp(n_valid // 2, 0, N - 1)
        med = err_sorted[:, mid]
        score = -med
        best = torch.argmax(score)
        best_med = med[best]
        # OpenCV-style robust sigma from the best median:
        # 2.5 * 1.4826 * (1 + 5/(n-8)) * sqrt(med); the gate is err < sigma^2,
        # floored at the caller's threshold.
        sigma = 2.5 * 1.4826 * (1.0 + 5.0 / torch.clamp(n_valid - 8, min=1)) \
            * torch.sqrt(torch.clamp(best_med, min=1e-18))
        thr = torch.clamp(sigma * sigma, min=threshold).to(p.dtype)
    else:
        inl = (err < threshold) & valid[None, :]
        score = torch.sum(inl, dim=-1).to(p.dtype)
        # First maximum on ties, as jnp.argmax.
        best = torch.argmax(score)
        thr = torch.tensor(threshold, dtype=p.dtype, device=p.device)

    E_best = Es[best]
    inliers = (essential.sampson_error(E_best, p, p_t) < thr) & valid
    if refit:
        # Guarded refit: keep it only with >= 8 support points and no loss
        # of inliers versus the winning hypothesis.
        w = inliers.to(p.dtype)
        E_refit = essential.eight_point(p, p_t, weights=w)
        inl_refit = (essential.sampson_error(E_refit, p, p_t) < thr) & valid
        use_refit = (torch.sum(inliers) >= MIN_SAMPLE) & (
            torch.sum(inl_refit) >= torch.sum(inliers)
        )
        E_final = torch.where(use_refit, E_refit, E_best)
        inliers = torch.where(use_refit, inl_refit, inliers)
    else:
        E_final = E_best

    return RansacResult(
        E=E_final,
        inliers=inliers,
        n_inliers=torch.sum(inliers).to(torch.int32),
        best_score=score[best],
    )
