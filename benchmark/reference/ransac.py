"""Batched robust essential-matrix estimation, 8-point RANSAC and LMedS: a
frozen copy of the port's ``epivo_tpu_torch/ransac.py`` on one device.

``n_hyp`` minimal samples are drawn at once by a Gumbel top-k over uniforms
from a ``torch.Generator``, solved with one batched 8-point solve, scored
against all N matches, and reduced with an argmax.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import essential

MIN_SAMPLE = 8  # 8-point minimal sample


class RansacResult(NamedTuple):
    """One pair's result; a batched call gives every field a leading [B]."""

    E: torch.Tensor  # [3, 3] best (refit) essential matrix
    inliers: torch.Tensor  # [N] bool
    n_inliers: torch.Tensor  # [] int32
    best_score: torch.Tensor  # [] hypothesis score (count or -median)


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    broken toward the lower index, as ``jax.lax.top_k`` does (the order of
    ``torch.topk`` among ties is unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def draw_uniforms(generator, n_hyp: int, N: int, lead: tuple = ()) -> torch.Tensor:
    """The uniforms [*lead, n_hyp, N] behind the samples, on the
    generator's device: the only part of the draw that consumes the
    generator."""
    return torch.rand(tuple(lead) + (n_hyp, N), generator=generator, device=generator.device)


def gumbel_top_k(u: torch.Tensor, mask: torch.Tensor | None,
                 sample_size: int = MIN_SAMPLE, device=None) -> torch.Tensor:
    """Sample indices [..., n_hyp, sample_size] from uniforms u [..., n_hyp,
    N]: Gumbel noise, the validity mask [..., N], and the top-k."""
    u = torch.clamp(u, min=torch.finfo(u.dtype).tiny)
    g = (-torch.log(-torch.log(u))).to(device)
    if mask is not None:
        g = torch.where(mask[..., None, :], g, -torch.inf)
    return top_k_stable(g, sample_size)[1]


def ransac_essential(
    uniforms: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    threshold: float = 1e-3,
    mask: torch.Tensor | None = None,
    method: str = "ransac",
    refit: bool = True,
) -> RansacResult:
    """Robust essential-matrix estimation over batched hypotheses.

    Args:
      uniforms: [B, n_hyp, N] uniforms of :func:`draw_uniforms`, turned
        into the samples by the Gumbel top-k over ``mask``.
      p, p_t: [B, N, 3] normalized matches (padded; use ``mask``).
      threshold: Sampson inlier threshold in squared normalized units.
      mask: [B, N] validity of the padded matches.
      method: "ransac" (inlier count) or "lmeds" (least median of squares).
      refit: refit E on the winning inlier set (guarded weighted 8-point).

    Every lane picks its own winner (first maximum on ties), its own LMedS
    median and its own guarded refit.
    """
    if method not in ("ransac", "lmeds"):
        raise ValueError(f"unknown method {method!r}")
    B, N = p.shape[:2]
    valid = mask if mask is not None else torch.ones((B, N), dtype=torch.bool,
                                                     device=p.device)
    n_valid = torch.sum(valid, dim=-1)  # [B]
    idx = gumbel_top_k(uniforms, mask, MIN_SAMPLE, device=p.device)
    lane = torch.arange(B, device=p.device)
    p_s, p_ts = p[lane[:, None, None], idx], p_t[lane[:, None, None], idx]
    # Hypotheses are projected to the essential manifold (regularizes
    # near-degenerate minimal samples).
    Es = essential.eight_point(p_s, p_ts, project=True)  # [B, H, 3, 3]
    H = Es.shape[1]

    err = essential.sampson_error(Es, p[:, None], p_t[:, None])  # [B, H, N]
    err = torch.where(valid[:, None, :], err, torch.inf)

    if method == "lmeds":
        # Median over each lane's valid entries: sort and take the entry at
        # that lane's n_valid // 2.
        err_sorted = torch.sort(err, dim=-1).values
        mid = torch.clamp(n_valid // 2, 0, N - 1)
        med = torch.gather(err_sorted, -1, mid[:, None, None].expand(B, H, 1))[..., 0]
        score = -med  # [B, H]
    else:
        inl = (err < threshold) & valid[:, None, :]
        score = torch.sum(inl, dim=-1).to(p.dtype)
    # First maximum on ties, as jnp.argmax.
    best = torch.argmax(score, dim=-1)  # [B]
    if method == "lmeds":
        best_med = -score[lane, best]
        # OpenCV-style robust sigma from the best median:
        # 2.5 * 1.4826 * (1 + 5/(n-8)) * sqrt(med); the gate is err < sigma^2,
        # floored at the caller's threshold.
        sigma = 2.5 * 1.4826 * (1.0 + 5.0 / torch.clamp(n_valid - 8, min=1)) \
            * torch.sqrt(torch.clamp(best_med, min=1e-18))
        thr = torch.clamp(sigma * sigma, min=threshold).to(p.dtype)
    else:
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
