"""Epipolar-depth residuals and their analytic SE(3) Jacobian (a frozen copy of the
port's ``epivo_tpu_torch/geometry/epipolar.py``).

For a match (p, p') in normalized homogeneous coordinates and a relative
pose (R, t) from the source into the target frame, the source depth has
the closed form

    d = ||P' t|| / ||P' R p||,    P' = [[1, 0, -x'], [0, 1, -y']]

and the residual is the Huber-robustified half-squared reprojection error
of X' = R (d p) + t against p'. Invalid points give exactly zero residual
and zero Jacobian (branch-free masks).
"""

from __future__ import annotations

import torch

from benchmark.reference import se3

DEFAULT_HUBER_DELTA = 1e-5
_SAFE_EPS = 1e-12


def pbar(p_t: torch.Tensor) -> torch.Tensor:
    """Build P' = [[1,0,-x'],[0,1,-y']] for target points [..., 3] -> [..., 2, 3]."""
    x, y = p_t[..., 0], p_t[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    row0 = torch.stack([one, zero, -x], dim=-1)
    row1 = torch.stack([zero, one, -y], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def epipolar_depth(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor,
                   p_t: torch.Tensor):
    """Closed-form source depth d = ||P' t|| / ||P' R p||.

    R [..., 3, 3], t [..., 3], p / p_t [..., N, 3]. Returns
    (d [..., N], valid [..., N]) with d = 0 where degenerate.
    """
    P = pbar(p_t)  # [..., N, 2, 3]
    A = torch.einsum("...nij,...j->...ni", P, t)  # [..., N, 2]
    Rp = torch.einsum("...ij,...nj->...ni", R, p)  # [..., N, 3]
    B = torch.einsum("...nij,...nj->...ni", P, Rp)  # [..., N, 2]
    nA = torch.linalg.norm(A, dim=-1)
    nB = torch.linalg.norm(B, dim=-1)
    valid = nB > _SAFE_EPS
    d = torch.where(valid, nA / torch.where(valid, nB, 1.0), 0.0)
    return d, valid


def huber(s: torch.Tensor, delta: float) -> torch.Tensor:
    """Robustifier on the half-squared error s = ||e||^2 / 2:
    rho(s) = s if s <= delta else delta * (sqrt(s) - delta/2)."""
    safe_s = torch.clamp(s, min=_SAFE_EPS)
    return torch.where(s <= delta, s, delta * (torch.sqrt(safe_s) - delta / 2.0))


def huber_deriv(s: torch.Tensor, delta: float) -> torch.Tensor:
    """Exact d rho / d s of :func:`huber`."""
    safe_s = torch.clamp(s, min=_SAFE_EPS)
    return torch.where(s <= delta, torch.ones_like(s),
                       delta / (2.0 * torch.sqrt(safe_s)))


def residual(
    R: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    huber_delta: float = DEFAULT_HUBER_DELTA,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-point robust reprojection residual [..., N] (0 where invalid)."""
    d, valid = epipolar_depth(R, t, p, p_t)
    X = p * d[..., None]  # [..., N, 3]
    X_t = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = X_t[..., 2]
    z_valid = torch.abs(z) > _SAFE_EPS
    safe_z = torch.where(z_valid, z, 1.0)
    proj = X_t / safe_z[..., None]
    diff = proj - p_t
    s = 0.5 * torch.sum(diff * diff, dim=-1)
    r = huber(s, huber_delta)
    ok = valid & z_valid
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, r, 0.0)


def residual_jacobian(
    Tl: torch.Tensor,
    Tr: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    reverse,
    huber_delta: float = DEFAULT_HUBER_DELTA,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Analytic Jacobian of :func:`residual` w.r.t. a pose-chain perturbation.

    The composed pose is ``T(eps) = Tl @ expm(sign * eps) @ Tr`` at
    ``eps = 0``, with ``sign = -1`` where ``reverse``. Tl, Tr [..., 4, 4];
    p, p_t [..., N, 3]; reverse a bool or a bool tensor broadcastable to
    the batch shape; mask [..., N]. Leading dimensions broadcast, which is
    how the LM assembles all (constraint, pose) pairs at once.

    Returns J [..., N, 6] (eps order: translation, rotation).
    """
    dtype, device = Tl.dtype, Tl.device
    G = se3.generators(dtype, device)  # [6, 4, 4]
    # A Python bool becomes a tensor by a device fill, not a host copy (a
    # captured graph may not copy from the host).
    rev = (reverse.to(device) if isinstance(reverse, torch.Tensor)
           else torch.full((), bool(reverse), device=device))
    sign = torch.where(rev, -1.0, 1.0).to(dtype)

    T0 = se3.mul44(Tl, Tr)
    R0 = T0[..., :3, :3]
    t0 = T0[..., :3, 3]

    # dT_k = sign * Tl @ G_k @ Tr  -> [..., 6, 4, 4]
    dT = sign[..., None, None, None] * torch.einsum(
        "...ij,kjl,...lm->...kim", Tl, G, Tr
    )
    dR = dT[..., :3, :3]  # [..., 6, 3, 3]
    dt = dT[..., :3, 3]  # [..., 6, 3]

    P = pbar(p_t)  # [..., N, 2, 3]
    A = torch.einsum("...nij,...j->...ni", P, t0)  # [..., N, 2]
    Rp = torch.einsum("...ij,...nj->...ni", R0, p)  # [..., N, 3]
    B = torch.einsum("...nij,...nj->...ni", P, Rp)  # [..., N, 2]

    # J_A[n, i, k] = (P_n dt_k)_i ;  J_B[n, i, k] = (P_n dR_k p_n)_i
    J_A = torch.einsum("...nij,...kj->...nik", P, dt)  # [..., N, 2, 6]
    dRp = torch.einsum("...kij,...nj->...nki", dR, p)  # [..., N, 6, 3]
    J_B = torch.einsum("...nij,...nkj->...nik", P, dRp)  # [..., N, 2, 6]

    ATA = torch.sum(A * A, dim=-1)  # [..., N]
    BTB = torch.sum(B * B, dim=-1)
    ok = (ATA > _SAFE_EPS) & (BTB > _SAFE_EPS)
    safe_ATA = torch.where(ok, ATA, 1.0)
    safe_BTB = torch.where(ok, BTB, 1.0)
    nA = torch.sqrt(safe_ATA)
    nB = torch.sqrt(safe_BTB)

    # d d/d eps = (|B|/|A| A^T J_A - |A|/|B| B^T J_B) / |B|^2
    AtJA = torch.einsum("...ni,...nik->...nk", A, J_A)  # [..., N, 6]
    BtJB = torch.einsum("...ni,...nik->...nk", B, J_B)
    J_d = ((nB / nA)[..., None] * AtJA - (nA / nB)[..., None] * BtJB) \
        / safe_BTB[..., None]  # [..., N, 6]

    d0 = nA / nB  # [..., N]
    Hpd = torch.cat([p * d0[..., None], torch.ones_like(d0)[..., None]],
                    dim=-1)  # [..., N, 4]

    # J_X = dT_k @ Hpd + T0 @ [p;0] * J_d, first 3 rows.
    term1 = torch.einsum("...kij,...nj->...nik", dT[..., :3, :], Hpd)  # [..., N, 3, 6]
    T0p = torch.einsum("...ij,...nj->...ni", R0, p)  # [..., N, 3]
    term2 = T0p[..., :, None] * J_d[..., None, :]  # [..., N, 3, 6]
    J_X = term1 + term2

    # Projection chain: X0 = R0 (d p) + t0; e = X0/z - p'.
    X0 = Rp * d0[..., None] + t0[..., None, :]  # [..., N, 3]
    z = X0[..., 2]
    z_ok = torch.abs(z) > _SAFE_EPS
    safe_z = torch.where(z_ok, z, 1.0)
    inv_z = 1.0 / safe_z
    proj = X0 * inv_z[..., None]
    e = proj - p_t  # [..., N, 3] (third component 0)
    ex, ey = e[..., 0], e[..., 1]
    eT_JPi = torch.stack(
        [ex * inv_z, ey * inv_z,
         -(ex * proj[..., 0] + ey * proj[..., 1]) * inv_z],
        dim=-1,
    )  # [..., N, 3]

    s = 0.5 * torch.sum(e * e, dim=-1)
    drho = huber_deriv(s, huber_delta)  # [..., N]

    J = drho[..., None] * torch.einsum("...ni,...nik->...nk", eT_JPi, J_X)

    good = ok & z_ok
    if mask is not None:
        good = good & mask
    return torch.where(good[..., None], J, 0.0)


def residual_from_T(
    T: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    huber_delta: float = DEFAULT_HUBER_DELTA,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Residual taking a homogeneous 4x4 pose directly."""
    return residual(T[..., :3, :3], T[..., :3, 3], p, p_t, huber_delta, mask)


def triangulate(
    R: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    min_b_norm: float = 1e-2,
):
    """Two-view triangulation by closed-form depth.

    Returns (X [..., N, 3] in the source frame, valid [..., N]) where valid
    means ||P' R p|| > ``min_b_norm``.
    """
    P = pbar(p_t)
    A = torch.einsum("...nij,...j->...ni", P, t)
    Rp = torch.einsum("...ij,...nj->...ni", R, p)
    B = torch.einsum("...nij,...nj->...ni", P, Rp)
    nB = torch.linalg.norm(B, dim=-1)
    valid = nB > min_b_norm
    d = torch.where(valid, torch.linalg.norm(A, dim=-1) / torch.where(valid, nB, 1.0),
                    0.0)
    return p * d[..., None], valid
