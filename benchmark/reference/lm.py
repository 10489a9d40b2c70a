"""Levenberg-Marquardt over SE(3) pose chains (a frozen copy of the
port's ``epivo_tpu_torch/optim/lm.py``: ``build_system``, ``solve`` and
``solve_batched``).

One solver, :func:`solve_batched`, with the window (or pair) axis first:
the reference's ``jax.vmap(solve)`` written out as a leading axis, so one
iteration is the same launches whatever the number of windows. It runs a
fixed number of iterations with masked accept/reject (lambda / 2 on
accept, x 5 on reject), a NaN guard and a small-step exit, all as
per-window tensor masks, so the loop never syncs with the host. The
Jacobian of every (window, constraint, pose) triple is one broadcast call
of ``epipolar.residual_jacobian``. :func:`solve` is its W = 1 case.

The reference's second batched solver, ``optim/lm_lanes.py``, computes the
same function in a lane-major layout that exists only for the TPU; it is
not ported (its parity test in the port holds this solver to it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference._device import constant, to_device
from benchmark.reference import epipolar, se3
from benchmark.reference import smallchol


class LMResult(NamedTuple):
    """Solver state; :func:`solve_batched` gives every field a leading [W]."""

    T0s: torch.Tensor  # [Z, 4, 4] optimized poses
    r_norm: torch.Tensor  # [] final residual norm (weighted)
    H_norm: torch.Tensor  # [] Frobenius norm of last damped Hessian
    lam: torch.Tensor  # [] final damping
    n_accepted: torch.Tensor  # [] int, accepted steps
    converged: torch.Tensor  # [] bool, hit the small-step exit


def _compose_reps(T0_mem: torch.Tensor, reps: torch.Tensor) -> torch.Tensor:
    """Composed pose per reprojection span: forward product or inverse.
    T0_mem [..., Z, Z, 4, 4]; reps [R, 2] int; returns [..., R, 4, 4]."""
    z0, z1 = reps[:, 0], reps[:, 1]
    fwd = T0_mem[..., torch.minimum(z0, z1), torch.maximum(z0, z1), :, :]
    return torch.where((z0 <= z1)[:, None, None], fwd, se3.inverse(fwd))


def _zeta_frames(T0_mem: torch.Tensor, reps: torch.Tensor, Z: int):
    """Left/right composed transforms around each (rep, zeta) pair.

    forward (z0 <= z1), zeta k in [z0, z1]:
        Tl = T0_mem[k, z1],  Tr = T0_mem[z0, k-1]  (identity when k == z0)
    reverse (z0 > z1), zeta k in [z1, z0]:
        Tl = inv(T0_mem[z1, k]),  Tr = inv(T0_mem[k+1, z0])  (identity when k == z0)

    T0_mem [..., Z, Z, 4, 4]. Returns (Tl [..., R, Z, 4, 4], Tr [..., R, Z,
    4, 4], participate [R, Z] bool, reverse [R] bool).
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

    def at(i, j):
        return T0_mem[..., i, j, :, :]

    Tl_f = at(k_grid, torch.maximum(z1g, k_grid))
    Tr_f = torch.where((k_grid > z0g)[..., None, None],
                       at(z0g, torch.clamp(k_grid - 1, min=0)), eye)
    Tl_r = se3.inverse(at(z1g, torch.maximum(k_grid, z1g)))
    Tr_r = torch.where((k_grid < z0g)[..., None, None],
                       se3.inverse(at(torch.clamp(k_grid + 1, max=Z - 1), z0g)),
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

    T0s [..., Z, 4, 4]; reps [R, 2] (shared); wreps [..., R]; p, p_t
    [..., R, N, 3]; pmask [..., R, N]. The leading axes (none, or windows)
    match across the arguments. Returns (r [..., R, N], J [..., R, N, Z,
    6]), both pre-multiplied by wreps.
    """
    Z = T0s.shape[-3]
    T0_mem = se3.prefix_products(T0s)  # [..., Z, Z, 4, 4]
    T0r = _compose_reps(T0_mem, reps)  # [..., R, 4, 4]

    r = epipolar.residual_from_T(T0r, p, p_t, huber_delta, pmask)  # [..., R, N]
    r = r * wreps[..., None]

    Tl, Tr, part, rev = _zeta_frames(T0_mem, reps, Z)
    pm = pmask if pmask is not None else torch.ones(p.shape[:-1], dtype=torch.bool,
                                                    device=p.device)
    # Broadcast over [..., R, Z]: points are shared by the zetas of one rep.
    J = epipolar.residual_jacobian(Tl, Tr, p[..., None, :, :], p_t[..., None, :, :],
                                   rev[:, None], huber_delta,
                                   pm[..., None, :])  # [..., R, Z, N, 6]
    J = J.transpose(-3, -2)  # [..., R, N, Z, 6]
    J = J * part[:, None, :, None] * wreps[..., None, None, None]
    return r, J


def _on(x, dtype: torch.dtype, device, fixed: bool = True) -> torch.Tensor:
    """An argument as a tensor of ``dtype`` on ``device``: a tensor is
    moved (a no-op where it already lies there); host data is built once
    as a device constant where it is ``fixed`` (the window structure),
    else on every call (weights)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype, non_blocking=True)
    return (constant if fixed else to_device)(x, dtype, device)


def solve_batched(
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
    """Joint LM optimization of W independent pose chains at once.

    T0s [W, Z, 4, 4] initial poses; reps [R, 2] (z0, z1) spans shared by
    every window (z0 > z1 means a reversed chain); p, p_t [W, R, N, 3];
    wreps [W, R] weights (default 1); pmask [W, R, N]; zeta_mask [Z]
    (False freezes that pose exactly in every window). Runs on T0s's
    device with no host sync; every field of the result has a leading [W].
    """
    W, Z = T0s.shape[:2]
    D = Z * 6
    R_ = reps.shape[0]
    dtype, device = T0s.dtype, T0s.device
    reps = _on(reps, torch.int64, device)
    wreps = (torch.ones((W, R_), dtype=dtype, device=device) if wreps is None
             else _on(wreps, dtype, device, fixed=False))
    zmask = (torch.ones(Z, dtype=torch.bool, device=device) if zeta_mask is None
             else _on(zeta_mask, torch.bool, device))
    eye = torch.eye(D, dtype=dtype, device=device)

    def energy(Ts):
        T0r = _compose_reps(se3.prefix_products(Ts), reps)
        r = epipolar.residual_from_T(T0r, p, p_t, huber_delta, pmask) * wreps[..., None]
        return torch.linalg.norm(r.reshape(W, -1), dim=-1)  # [W]

    Ts = T0s
    lam = torch.full((W,), lambda0, dtype=dtype, device=device)
    prev_E = torch.full((W,), torch.inf, dtype=dtype, device=device)
    H_norm = torch.zeros(W, dtype=dtype, device=device)
    n_acc = torch.zeros(W, dtype=torch.int32, device=device)
    done = torch.zeros(W, dtype=torch.bool, device=device)
    for _ in range(max_iters):
        r, J = build_system(Ts, reps, wreps, p, p_t, huber_delta, pmask)
        r_flat = r.reshape(W, -1)  # [W, R*N]
        J_flat = J.reshape(W, -1, D)  # [W, R*N, D]

        b = (J_flat.mT @ r_flat[..., None])[..., 0]  # [W, D]
        H = J_flat.mT @ J_flat  # [W, D, D]
        diag = torch.diagonal(H, dim1=-2, dim2=-1)  # [W, D]
        H_damped = H + lam[:, None, None] * torch.diag_embed(diag)
        # Tikhonov floor relative to H's scale (H can sit at ~1e-10).
        h_scale = torch.mean(diag, dim=-1) + 1e-30
        H_damped = H_damped + (1e-7 * h_scale)[:, None, None] * eye
        delta = -smallchol.solve_spd_small(H_damped, b)  # [W, D]

        nan_step = ~torch.all(torch.isfinite(delta), dim=-1)
        small_step = torch.linalg.norm(delta, dim=-1) < epsilon
        delta = torch.where(nan_step[:, None], torch.zeros_like(delta), delta)

        dT = se3.se3_exp(delta.reshape(W, Z, 6))
        Ts_cand = torch.einsum("wzij,wzjk->wzik", Ts, dT)
        Ts_cand = torch.where(zmask[:, None, None], Ts_cand, Ts)

        cand_E = energy(Ts_cand)
        accept = (cand_E < prev_E) & ~nan_step & ~small_step & ~done

        Ts = torch.where(accept[:, None, None, None], Ts_cand, Ts)
        prev_E = torch.where(accept, cand_E, prev_E)
        lam = torch.where(done, lam, torch.where(accept, lam / 2.0, lam * 5.0))
        H_norm = torch.where(done, H_norm,
                             torch.linalg.norm(H_damped.reshape(W, -1), dim=-1))
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


def solve(
    T0s: torch.Tensor,
    reps: torch.Tensor,
    p: torch.Tensor,
    p_t: torch.Tensor,
    wreps: torch.Tensor | None = None,
    pmask: torch.Tensor | None = None,
    zeta_mask: torch.Tensor | None = None,
    **kwargs,
) -> LMResult:
    """One pose chain: :func:`solve_batched` with W = 1.

    T0s [Z, 4, 4]; reps [R, 2]; p, p_t [R, N, 3]; wreps [R]; pmask [R, N];
    zeta_mask [Z]; keyword arguments as :func:`solve_batched`.
    """
    lead = lambda x: None if x is None else torch.as_tensor(x)[None]
    out = solve_batched(T0s[None], reps, p[None], p_t[None],
                        wreps=lead(wreps), pmask=lead(pmask), zeta_mask=zeta_mask, **kwargs)
    return LMResult(*(f[0] for f in out))
