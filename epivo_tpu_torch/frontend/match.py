"""Descriptor matching: Hamming distance as one matmul (port of
``epivo_tpu/frontend/match.py``).

With descriptors as {-1, +1} vectors d of length B, the Hamming distance
is H(a, b) = (B - a . b) / 2, so the whole N1 x N2 distance table is one
[N1, B] x [B, N2] product, exact in float32 (every partial sum is an
integer below 2^24; TF32 is off, and ±1 is exact in it anyway).
Cross-check (mutual nearest neighbour) and the Lowe ratio test are masked
argmin reductions. Distances are integers, so ties are the normal case:
``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does.
Every function takes optional leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MatchResult(NamedTuple):
    idx: torch.Tensor  # [..., N1] best match in set 2 (or -1)
    dist: torch.Tensor  # [..., N1] Hamming distance of the best match
    valid: torch.Tensor  # [..., N1] bool: passed cross-check/ratio/threshold


def hamming_table(signs1: torch.Tensor, signs2: torch.Tensor) -> torch.Tensor:
    """[..., N1, B] x [..., N2, B] {-1, +1} descriptors -> [..., N1, N2]
    Hamming distances."""
    B = signs1.shape[-1]
    dot = torch.matmul(signs1, signs2.transpose(-1, -2))
    return (B - dot) * 0.5


def match(
    signs1: torch.Tensor,
    signs2: torch.Tensor,
    valid1: torch.Tensor | None = None,
    valid2: torch.Tensor | None = None,
    cross_check: bool = True,
    max_dist: float = 80.0,
    ratio: float | None = None,
) -> MatchResult:
    """Nearest-neighbour Hamming matching with optional cross-check and
    ratio test; ``max_dist`` is the absolute Hamming gate. Makes no host
    sync."""
    D = hamming_table(signs1, signs2)  # [..., N1, N2]
    if valid1 is not None:
        D = torch.where(valid1[..., :, None], D, torch.inf)
    if valid2 is not None:
        D = torch.where(valid2[..., None, :], D, torch.inf)

    best2 = torch.argmin(D, dim=-1)  # [..., N1], first minimum
    dist = torch.amin(D, dim=-1)
    ok = dist <= max_dist

    if ratio is not None:
        N2 = D.shape[-1]
        lane = torch.arange(N2, device=D.device)
        second = torch.amin(torch.where(lane == best2[..., None], torch.inf, D), dim=-1)
        ok = ok & (dist < ratio * second)

    if cross_check:
        best1 = torch.argmin(D, dim=-2)  # [..., N2] best row for each column
        rows = torch.arange(D.shape[-2], device=D.device)
        ok = ok & (torch.gather(best1, -1, best2) == rows)

    idx = torch.where(ok, best2, -1)
    return MatchResult(idx=idx, dist=dist, valid=ok)
