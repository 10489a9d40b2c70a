"""Levenberg-Marquardt over SE(3) pose chains (port of
``epivo_tpu/optim/lm.py``: ``build_system`` and ``solve``).

A fixed number of iterations with masked accept/reject (lambda / 2 on
accept, x 5 on reject), a NaN guard and a small-step exit, all as tensor
masks so the loop never syncs with the host. The Jacobian of every
(constraint, pose) pair is one broadcast call of
``epipolar.residual_jacobian`` over [R, Z].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from epivo_tpu_torch.geometry import epipolar, se3
from epivo_tpu_torch.optim import smallchol


class LMResult(NamedTuple):
    T0s: torch.Tensor  # [Z, 4, 4] optimized poses
    r_norm: torch.Tensor  # [] final residual norm (weighted)
    H_norm: torch.Tensor  # [] Frobenius norm of last damped Hessian
    lam: torch.Tensor  # [] final damping
    n_accepted: torch.Tensor  # [] int, accepted steps
    converged: torch.Tensor  # [] bool, hit the small-step exit


def _compose_reps(T0_mem: torch.Tensor, reps: torch.Tensor) -> torch.Tensor:
    """Composed pose per reprojection span: forward product or inverse.
    reps [R, 2] int; returns [R, 4, 4]."""
    z0, z1 = reps[:, 0], reps[:, 1]
    fwd = T0_mem[torch.minimum(z0, z1), torch.maximum(z0, z1)]  # [R, 4, 4]
    return torch.where((z0 <= z1)[:, None, None], fwd, se3.inverse(fwd))


def _zeta_frames(T0_mem: torch.Tensor, reps: torch.Tensor, Z: int):
    """Left/right composed transforms around each (rep, zeta) pair.

    forward (z0 <= z1), zeta k in [z0, z1]:
        Tl = T0_mem[k, z1],  Tr = T0_mem[z0, k-1]  (identity when k == z0)
    reverse (z0 > z1), zeta k in [z1, z0]:
        Tl = inv(T0_mem[z1, k]),  Tr = inv(T0_mem[k+1, z0])  (identity when k == z0)

    Returns (Tl [R,Z,4,4], Tr [R,Z,4,4], participate [R,Z] bool, reverse [R] bool).
    """
    R_ = reps.shape[0]
    z0, z1 = reps[:, 0], reps[:, 1]
    rev = z0 > z1
    ks = torch.arange(Z, device=reps.device)
    lo = torch.minimum(z0, z1)[:, None]
    hi = torch.maximum(z0, z1)[:, None]
    part = (ks[None, :] >= lo) & (ks[None, :] <= hi)  # [R, Z]

    k_grid = ks[None, :].expand(R_, Z)
    z0g = z0[:, None].expand(R_, Z)
    z1g = z1[:, None].expand(R_, Z)
    eye = torch.eye(4, dtype=T0_mem.dtype, device=T0_mem.device)

    Tl_f = T0_mem[k_grid, torch.maximum(z1g, k_grid)]
    Tr_f = torch.where((k_grid > z0g)[..., None, None],
                       T0_mem[z0g, torch.clamp(k_grid - 1, min=0)], eye)
    Tl_r = se3.inverse(T0_mem[z1g, torch.maximum(k_grid, z1g)])
    Tr_r = torch.where((k_grid < z0g)[..., None, None],
                       se3.inverse(T0_mem[torch.clamp(k_grid + 1, max=Z - 1), z0g]),
                       eye)

    rev_b = rev[:, None, None, None]
    return (torch.where(rev_b, Tl_r, Tl_f), torch.where(rev_b, Tr_r, Tr_f),
            part, rev)


def build_system(
    T0s: torch.Tensor,
    reps: torch.Tensor,
    wreps: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    huber_delta: float,
    pmask: torch.Tensor | None = None,
):
    """Assemble the weighted residual stack and Jacobian.

    T0s [Z, 4, 4]; reps [R, 2]; wreps [R]; p, p_t [R, N, 3]; pmask [R, N].
    Returns (r [R, N], J [R, N, Z, 6]), both pre-multiplied by wreps.
    """
    Z = T0s.shape[0]
    T0_mem = se3.prefix_products(T0s)  # [Z, Z, 4, 4]
    T0r = _compose_reps(T0_mem, reps)  # [R, 4, 4]

    r = epipolar.residual_from_T(T0r, p, p_t, huber_delta, pmask)  # [R, N]
    r = r * wreps[:, None]

    Tl, Tr, part, rev = _zeta_frames(T0_mem, reps, Z)
    pm = pmask if pmask is not None else torch.ones(p.shape[:2], dtype=torch.bool,
                                                    device=p.device)
    # Broadcast over [R, Z]: points are shared by the zetas of one rep.
    J = epipolar.residual_jacobian(Tl, Tr, p[:, None], p_t[:, None],
                                   rev[:, None], huber_delta,
                                   pm[:, None])  # [R, Z, N, 6]
    J = J.transpose(1, 2)  # [R, N, Z, 6]
    J = J * part[:, None, :, None] * wreps[:, None, None, None]
    return r, J


def solve(
    T0s: torch.Tensor,
    reps: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    wreps: torch.Tensor | None = None,
    pmask: torch.Tensor | None = None,
    zeta_mask: torch.Tensor | None = None,
    lambda0: float = 1e-2,
    epsilon: float = 1e-8,
    max_iters: int = 30,
    huber_delta: float = epipolar.DEFAULT_HUBER_DELTA,
) -> LMResult:
    """Joint LM optimization of a pose chain over reprojection constraints.

    T0s [Z, 4, 4] initial poses; reps [R, 2] (z0, z1) spans (z0 > z1 means a
    reversed chain); p, p_t [R, N, 3]; wreps [R] weights (default 1);
    pmask [R, N]; zeta_mask [Z] (False freezes that pose exactly).
    """
    Z = T0s.shape[0]
    R_ = reps.shape[0]
    dtype, device = T0s.dtype, T0s.device
    reps = torch.as_tensor(reps, dtype=torch.int64, device=device)
    if wreps is None:
        wreps = torch.ones(R_, dtype=dtype, device=device)
    wreps = torch.as_tensor(wreps, dtype=dtype, device=device)
    zmask = (torch.ones(Z, dtype=torch.bool, device=device) if zeta_mask is None
             else torch.as_tensor(zeta_mask, device=device))
    eye = torch.eye(Z * 6, dtype=dtype, device=device)

    def energy(Ts):
        T0r = _compose_reps(se3.prefix_products(Ts), reps)
        r = epipolar.residual_from_T(T0r, p, p_t, huber_delta, pmask) * wreps[:, None]
        return torch.linalg.norm(r.reshape(-1))

    Ts = T0s
    lam = torch.tensor(lambda0, dtype=dtype, device=device)
    prev_E = torch.tensor(torch.inf, dtype=dtype, device=device)
    H_norm = torch.tensor(0.0, dtype=dtype, device=device)
    n_acc = torch.tensor(0, dtype=torch.int32, device=device)
    done = torch.tensor(False, device=device)
    for _ in range(max_iters):
        r, J = build_system(Ts, reps, wreps, p, p_t, huber_delta, pmask)
        r_flat = r.reshape(-1)  # [R*N]
        J_flat = J.reshape(r_flat.shape[0], Z * 6)

        b = J_flat.T @ r_flat
        H = J_flat.T @ J_flat
        diag = torch.diagonal(H)
        H_damped = H + lam * torch.diag(diag)
        # Tikhonov floor relative to H's scale (H can sit at ~1e-10).
        h_scale = torch.mean(diag) + 1e-30
        H_damped = H_damped + (1e-7 * h_scale) * eye
        delta = -smallchol.solve_spd_small(H_damped, b)

        nan_step = ~torch.all(torch.isfinite(delta))
        small_step = torch.linalg.norm(delta) < epsilon
        delta = torch.where(nan_step, torch.zeros_like(delta), delta)

        dT = se3.se3_exp(delta.reshape(Z, 6))
        Ts_cand = torch.einsum("zij,zjk->zik", Ts, dT)
        Ts_cand = torch.where(zmask[:, None, None], Ts_cand, Ts)

        cand_E = energy(Ts_cand)
        accept = (cand_E < prev_E) & ~nan_step & ~small_step & ~done

        Ts = torch.where(accept, Ts_cand, Ts)
        prev_E = torch.where(accept, cand_E, prev_E)
        lam = torch.where(done, lam, torch.where(accept, lam / 2.0, lam * 5.0))
        H_norm = torch.where(done, H_norm, torch.linalg.norm(H_damped))
        n_acc = n_acc + accept.to(torch.int32)
        done = done | nan_step | small_step

    return LMResult(
        T0s=Ts,
        r_norm=energy(Ts),
        H_norm=H_norm,
        lam=lam,
        n_accepted=n_acc,
        converged=done,
    )
