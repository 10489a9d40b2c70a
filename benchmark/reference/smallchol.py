"""Unrolled Cholesky for tiny SPD systems (a frozen copy of the
port's ``epivo_tpu_torch/optim/smallchol.py``).

Ported as it is, not as ``torch.linalg.cholesky``: that raises or returns
NaN on a non-SPD matrix, where the ``sqrt(max(s, 1e-30))`` guard keeps the
garbage local and finite. RANSAC and LM rely on that: a bad hypothesis or
step is rejected by its score, not by an exception.
"""

from __future__ import annotations

import torch


def cholesky_small(H: torch.Tensor):
    """Lower-triangular factor of [..., D, D] SPD H as a list-of-lists of
    [...]-shaped entries (no materialized matrix)."""
    D = H.shape[-1]
    L = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def chol_solve_small(L, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b for b [..., D] given :func:`cholesky_small` L."""
    D = len(L)
    y = [None] * D
    for i in range(D):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * D
    for i in range(D - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, D):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def solve_spd_small(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = H^-1 b for tiny SPD H [..., D, D], b [..., D]."""
    return chol_solve_small(cholesky_small(H), b)


def inv_spd_small(H: torch.Tensor) -> torch.Tensor:
    """H^-1 for tiny SPD H [..., D, D] (D unrolled solves)."""
    D = H.shape[-1]
    L = cholesky_small(H)
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    cols = [chol_solve_small(L, eye[k].expand(H.shape[:-2] + (D,)))
            for k in range(D)]
    return torch.stack(cols, dim=-1)
