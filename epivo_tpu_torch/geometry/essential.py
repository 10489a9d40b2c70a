"""Essential-matrix estimation and pose recovery (port of
``epivo_tpu/geometry/essential.py``).

Hypotheses are solved with the normalized 8-point algorithm batched over
many minimal samples; the smallest eigenvector comes from the same
fixed-iteration inverse iteration as the reference (not ``eigh``), because
the RANSAC argmax over hundreds of hypotheses flips on small differences.
All points are in normalized camera coordinates (homogeneous, z = 1).
"""

from __future__ import annotations

import torch

from epivo_tpu_torch._device import constant
from epivo_tpu_torch.geometry import linalg3, se3
from epivo_tpu_torch.optim import smallchol

_EPS = 1e-12


def design_rows(p: torch.Tensor, p_t: torch.Tensor) -> torch.Tensor:
    """Epipolar constraint rows: p_t^T E p = A @ vec(E) (row-major vec).

    p, p_t: [..., N, 3] -> [..., N, 9].
    """
    return (p_t[..., :, None] * p[..., None, :]).reshape(p.shape[:-1] + (9,))


def smallest_eigvec_9(AtA: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of a batched PSD 9x9 matrix
    via fixed-iteration inverse iteration on a ridge-shifted inverse."""
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    # The ridge keeps the factorization well-posed; for minimal 8-point
    # samples AtA is exactly rank 8, so it dominates only the null direction.
    M = AtA + 1e-7 * tr * torch.eye(9, dtype=AtA.dtype, device=AtA.device)
    Minv = smallchol.inv_spd_small(M)
    v = torch.full(AtA.shape[:-2] + (9,), 1.0 / 3.0, dtype=AtA.dtype,
                   device=AtA.device)
    for _ in range(iters):
        v = torch.einsum("...ij,...j->...i", Minv, v)
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    return v


def project_essential(E: torch.Tensor) -> torch.Tensor:
    """Project to the essential manifold: singular values (1, 1, 0), with
    proper-rotation U and V (closed-form ``linalg3.svd3``)."""
    U, _, Vt = linalg3.svd3(E)
    return U[..., :, 0:1] @ Vt[..., 0:1, :] + U[..., :, 1:2] @ Vt[..., 1:2, :]


def eight_point(p: torch.Tensor, p_t: torch.Tensor,
                weights: torch.Tensor | None = None,
                project: bool = True) -> torch.Tensor:
    """(Weighted) 8-point essential estimate.

    p, p_t: [..., N, 3] with N >= 8. Returns E [..., 3, 3], projected to
    singular values (1, 1, 0) when ``project``. Row weights (e.g. an inlier
    mask) give masked refits with static shapes.
    """
    A = design_rows(p, p_t)  # [..., N, 9]
    if weights is not None:
        A = A * weights[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    e = smallest_eigvec_9(AtA)
    E = e.reshape(e.shape[:-1] + (3, 3))
    if project:
        E = project_essential(E)
    return E


def sampson_error(E: torch.Tensor, p: torch.Tensor, p_t: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error of the epipolar constraint.

    E [..., 3, 3]; p, p_t [..., N, 3]. Returns [..., N] squared errors in
    normalized-coordinate units.
    """
    Ep = torch.einsum("...ij,...nj->...ni", E, p)  # [..., N, 3]
    Etp = torch.einsum("...ji,...nj->...ni", E, p_t)
    num = torch.einsum("...ni,...ni->...n", p_t, Ep)  # p_t^T E p
    den = Ep[..., 0] ** 2 + Ep[..., 1] ** 2 + Etp[..., 0] ** 2 + Etp[..., 1] ** 2
    return num * num / torch.clamp(den, min=_EPS)


def decompose(E: torch.Tensor):
    """E -> four (R, t) candidates: [..., 4, 3, 3], [..., 4, 3].

    E = U diag(1,1,0) V^T; R in {U W V^T, U W^T V^T}, t = +-u3 (unit norm).
    """
    U, _, Vt = linalg3.svd3(E)
    W = constant([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                 E.dtype, E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = torch.stack([Ra, Ra, Rb, Rb], dim=-3)  # [..., 4, 3, 3]
    ts = torch.stack([t, -t, t, -t], dim=-2)  # [..., 4, 3]
    return Rs, ts


def _depths_two_view(R, t, p, p_t):
    """Signed depths in both frames for cheirality checks.

    d_src = -(B . A)/(B . B) with A = P' t, B = P' R p; the target depth is
    the z of R (d p) + t. Returns (d_src [..., N], d_tgt [..., N]).
    """
    x, y = p_t[..., 0], p_t[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    P0 = torch.stack([one, zero, -x], dim=-1)
    P1 = torch.stack([zero, one, -y], dim=-1)
    Rp = torch.einsum("...ij,...nj->...ni", R, p)
    A0 = torch.einsum("...ni,...i->...n", P0, t)
    A1 = torch.einsum("...ni,...i->...n", P1, t)
    B0 = torch.einsum("...ni,...ni->...n", P0, Rp)
    B1 = torch.einsum("...ni,...ni->...n", P1, Rp)
    BdotA = B0 * A0 + B1 * A1
    BdotB = B0 * B0 + B1 * B1
    d_src = -BdotA / torch.clamp(BdotB, min=_EPS)
    X_t = Rp * d_src[..., None] + t[..., None, :]
    return d_src, X_t[..., 2]


def recover_pose(E: torch.Tensor, p: torch.Tensor, p_t: torch.Tensor,
                 mask: torch.Tensor | None = None):
    """Cheirality-checked pose recovery.

    Returns (R [..., 3, 3], t [..., 3], front [..., N] bool): the candidate
    with the most (masked) points in front of both cameras, and its
    per-point cheirality mask. Ties go to the first candidate.
    """
    Rs, ts = decompose(E)  # [..., 4, 3, 3], [..., 4, 3]
    d_src, d_tgt = _depths_two_view(
        Rs, ts, p[..., None, :, :], p_t[..., None, :, :]
    )  # [..., 4, N]
    front = (d_src > 0) & (d_tgt > 0)
    votes = front
    if mask is not None:
        votes = votes & mask[..., None, :]
    counts = torch.sum(votes, dim=-1)  # [..., 4]
    best = torch.argmax(counts, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        best.shape + (1, 3, 3))).squeeze(-3)
    t = torch.gather(ts, -2, best[..., None, None].expand(
        best.shape + (1, 3))).squeeze(-2)
    front_best = torch.gather(front, -2, best[..., None, None].expand(
        best.shape + (1, front.shape[-1]))).squeeze(-2)
    return R, t, front_best


def _tangent_basis(t: torch.Tensor):
    """Two unit vectors spanning the tangent plane at t [..., 3] on S^2."""
    e = torch.eye(3, dtype=t.dtype, device=t.device)
    a = torch.where(torch.abs(t[..., :1]) < 0.9, e[0], e[1])
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / (torch.linalg.norm(b1, dim=-1, keepdim=True) + _EPS)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return b1, b2


def _increments(delta, b1, b2):
    """Rotation and translation-direction increments of a 5-DoF step."""
    dR = se3.so3_exp(delta[..., :3])
    dt = se3.so3_exp(b1 * delta[..., 3:4] + b2 * delta[..., 4:5])
    return dR, dt


def _sampson_residual(delta, R, t, b1, b2, p, p_t, mf):
    """Signed first-order (Sampson) residual [..., N] of E = [t']_x R' after
    the step ``delta`` [..., 5] (not squared, for Gauss-Newton)."""
    dR, dt = _increments(delta, b1, b2)
    Ecur = se3.hat(torch.einsum("...ij,...j->...i", dt, t)) @ (R @ dR)
    Ep = torch.einsum("...ij,...nj->...ni", Ecur, p)
    Etp = torch.einsum("...ji,...nj->...ni", Ecur, p_t)
    num = torch.einsum("...ni,...ni->...n", p_t, Ep)
    den = torch.sqrt(
        Ep[..., 0] ** 2 + Ep[..., 1] ** 2
        + Etp[..., 0] ** 2 + Etp[..., 1] ** 2 + _EPS
    )
    return (num / den) * mf


# d residual / d delta at delta = 0, per pair: forward-mode AD of one
# pair's residual, mapped over the pair axis ([B, N, 5], never the
# [B, N, B, 5] block that a jacfwd of the whole batch would build).
_sampson_jacobian = torch.func.vmap(torch.func.jacfwd(_sampson_residual))


def refine_essential(
    E: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    mask: torch.Tensor | None = None,
    iters: int = 8,
    damping: float = 1e-6,
) -> torch.Tensor:
    """Gauss-Newton refinement of E on its 5-DoF manifold (Sampson cost).

    E = [t]_x R with a rotation increment (3 DoF) and a translation
    direction increment in the tangent plane of the unit sphere (2 DoF);
    a fixed number of damped GN steps, each accepted only if it lowers the
    cost. E [3, 3] with p, p_t [N, 3], or one leading pair axis on all
    (E [B, 3, 3], p [B, N, 3], mask [B, N]): every pair takes its own
    steps. The Jacobian comes from ``torch.func.jacfwd`` per pair, as the
    reference takes it from ``jax.jacfwd`` under ``jax.vmap``.
    """
    if E.dim() == 2:
        return refine_essential(E[None], p[None], p_t[None],
                                None if mask is None else mask[None],
                                iters, damping)[0]
    m = mask if mask is not None else torch.ones(p.shape[:-1], dtype=torch.bool,
                                                 device=p.device)
    mf = m.to(E.dtype)
    R, t, _ = recover_pose(E, p, p_t, mask=m)
    zero5 = torch.zeros(E.shape[:-2] + (5,), dtype=E.dtype, device=E.device)
    eye5 = torch.eye(5, dtype=E.dtype, device=E.device)

    for _ in range(iters):
        b1, b2 = _tangent_basis(t)
        frame = (R, t, b1, b2, p, p_t, mf)
        r0 = _sampson_residual(zero5, *frame)  # [B, N]
        J = _sampson_jacobian(zero5, *frame)  # [B, N, 5]
        H = J.mT @ J + damping * eye5
        delta = -smallchol.solve_spd_small(H, (J.mT @ r0[..., None])[..., 0])
        r1 = _sampson_residual(delta, *frame)
        accept = torch.sum(r1 * r1, dim=-1) < torch.sum(r0 * r0, dim=-1)
        delta = torch.where(accept[..., None], delta, torch.zeros_like(delta))
        dR, dt = _increments(delta, b1, b2)
        R, t = R @ dR, torch.einsum("...ij,...j->...i", dt, t)
    E_new = se3.hat(t) @ R
    return E_new / (torch.linalg.norm(E_new.flatten(-2), dim=-1)[..., None, None] + _EPS)


def pose_fallback(R: torch.Tensor, t: torch.Tensor,
                  fallback_t=(0.1, 0.1, -0.9),
                  trace_min: float = 2.7,
                  t_norm_min: float = 1e-5):
    """Degenerate-pose guards: near-degenerate rotation -> identity + canned
    translation; vanishing translation -> canned translation. Branch-free."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    bad_R = tr < trace_min
    canned = constant(fallback_t, R.dtype, R.device).expand(t.shape)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    R_out = torch.where(bad_R[..., None, None], eye, R)
    t_out = torch.where(bad_R[..., None], canned, t)
    bad_t = torch.linalg.norm(t_out, dim=-1) < t_norm_min
    t_out = torch.where(bad_t[..., None], canned, t_out)
    return R_out, t_out
