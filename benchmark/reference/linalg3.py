"""Closed-form batched 3x3 factorizations (a frozen copy of the
port's ``epivo_tpu_torch/geometry/linalg3.py``).

The same analytic route as the reference, not ``torch.linalg.svd`` or
``eigh``: their sign and ordering conventions differ, and ``decompose``
depends on these. Eigenvalues of the symmetric M^T M come from the
trigonometric (Cardano) formula, eigenvectors from cross products of
(A - lambda I) rows, and U from mapping V through M with an orthonormal
completion. Singular values descend; U and V are proper rotations.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-20


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion along row 0."""
    a = A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
    b = A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
    c = A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    return a - b + c


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def sym_eigh3_desc(A: torch.Tensor):
    """Eigendecomposition of symmetric [..., 3, 3]: (w desc [..., 3],
    V [..., 3, 3] with eigenvectors in columns, right-handed)."""
    I = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * I
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    r = det3(B) / (2.0 * (p * p * p) + _EPS)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w0 = q + 2.0 * p * torch.cos(phi)
    w2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)  # descending by construction

    def eigvec(lmbda):
        # Rows of (A - lambda I); the eigenvector is orthogonal to all rows.
        M = A - lmbda[..., None, None] * I
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01 = _cross(r0, r1)
        c12 = _cross(r1, r2)
        c20 = _cross(r2, r0)
        n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
        n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
        n20 = torch.sum(c20 * c20, dim=-1, keepdim=True)
        # Pick the largest cross product (most numerically stable).
        best12 = (n12 >= n01) & (n12 >= n20)
        best20 = (n20 >= n01) & ~best12
        v = torch.where(best12, c12, torch.where(best20, c20, c01))
        n = torch.where(best12, n12, torch.where(best20, n20, n01))
        return v / torch.sqrt(torch.clamp(n, min=_EPS))

    v0 = eigvec(w0)
    v2 = eigvec(w2)
    # Trust whichever end has the larger spectral gap and rebuild the other
    # by orthogonalization (essential matrices have w0 ~= w1).
    trust0 = (w0 - w1 >= w1 - w2)[..., None]

    def orth(u, against):
        u = u - torch.sum(against * u, dim=-1, keepdim=True) * against
        return u / torch.sqrt(
            torch.clamp(torch.sum(u * u, dim=-1, keepdim=True), min=_EPS))

    v0_f = torch.where(trust0, v0, orth(v0, v2))
    v2_f = torch.where(trust0, orth(v2, v0), v2)
    v1 = _cross(v2_f, v0_f)
    V = torch.stack([v0_f, v1, v2_f], dim=-1)  # columns
    return w, V


def svd3(M: torch.Tensor):
    """Batched [..., 3, 3] SVD with U, V proper rotations.

    Returns (U [..., 3, 3], s [..., 3] descending >= 0, Vt [..., 3, 3]).
    As in the reference, s stays >= 0 and u2 = u0 x u1, which is exact for
    rank-2 inputs (essential matrices).
    """
    w, V = sym_eigh3_desc(torch.einsum("...ji,...jk->...ik", M, M))
    s = torch.sqrt(torch.clamp(w, min=0.0))
    MV = torch.einsum("...ij,...jk->...ik", M, V)  # columns M v_k
    u0 = MV[..., :, 0] / torch.clamp(s[..., 0:1], min=_EPS)
    u1 = MV[..., :, 1] - torch.sum(MV[..., :, 1] * u0, dim=-1, keepdim=True) * u0
    u1 = u1 / torch.sqrt(
        torch.clamp(torch.sum(u1 * u1, dim=-1, keepdim=True), min=_EPS))
    u2 = _cross(u0, u1)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, s, V.transpose(-1, -2)
