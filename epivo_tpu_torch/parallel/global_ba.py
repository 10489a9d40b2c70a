"""Global (full-trajectory) bundle adjustment, on one device or with its
constraints sharded over a mesh (port of ``epivo_tpu/parallel/global_ba.py``).

ONE joint LM problem over the whole zeta chain, with

- **local Jacobians**: each constraint touches only its zeta span, so the
  Jacobian is stored as [R, N, S, 6] local blocks (S = the largest span)
  plus an index map, never as the dense [R*N, 6Z] matrix;
- **matrix-free damped normal equations**: H v is evaluated as
  sum_r J_r^T (J_r v[span_r]) by a gather and a fixed-order gather-sum
  (:func:`_scatter`), which adds the same terms in the same order on every
  run; an ``index_add_`` would sum with atomics in no fixed order on CUDA,
  and LM's accept test could then flip from run to run;
- **conjugate gradients** with Jacobi preconditioning, a fixed number of
  iterations and no early exit, so the solve never syncs with the host;
- **banded prefix products** (:func:`prefix_band`): every composed pose the
  system reads spans at most S zetas, so only the S diagonals of the
  reference's dense [Z, Z, 4, 4] prefix table are built, as S - 1 batched
  products in the reference's order.

With a ``mesh`` the constraint axis is sharded over its ``win`` axis, as
in the reference: each rank builds the local system of its own block of
constraints (its own incidence table), and the right-hand side, the
diagonal, every matvec and every energy are summed over the ranks by one
``all_reduce`` each (the reference's four ``psum``s; the right-hand side
and the diagonal share one). The poses, lambda and the accept test are
then the same on every rank, so every rank takes the same branch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from epivo_tpu_torch._device import constant
from epivo_tpu_torch.geometry import epipolar, se3
from epivo_tpu_torch.parallel import mesh as mesh_mod


class GlobalBAResult(NamedTuple):
    T0s: torch.Tensor  # [Z, 4, 4]
    r_norm: torch.Tensor  # []
    n_accepted: torch.Tensor  # [] int32
    lam: torch.Tensor  # []


def _span_data(reps: np.ndarray, max_span: int):
    """Static per-constraint span indexing: (zidx [R, S], zmask [R, S])."""
    z0 = reps[:, 0]
    z1 = reps[:, 1]
    lo = np.minimum(z0, z1)
    hi = np.maximum(z0, z1)
    S = max_span
    if int((hi - lo).max()) + 1 > S:
        raise ValueError(f"constraint span {int((hi - lo).max()) + 1} exceeds "
                         f"max_span {S}")
    zidx = lo[:, None] + np.arange(S)[None, :]
    zmask = zidx <= hi[:, None]
    zidx = np.minimum(zidx, hi[:, None])  # clamp (masked anyway)
    return zidx.astype(np.int32), zmask


def _incidence(zidx: np.ndarray, zmask: np.ndarray, Z: int):
    """The gather table of :func:`_scatter`: (inc [Z, C], inc_ok [Z, C]),
    row z listing the flat (constraint, slot) indices r * S + s with
    zidx[r, s] == z in ascending order (the order the reference's
    scatter-add visits them), padded to the largest count C."""
    flat = np.flatnonzero(zmask.reshape(-1))
    z_of = zidx.reshape(-1)[flat]
    order = np.argsort(z_of, kind="stable")
    counts = np.bincount(z_of, minlength=Z)
    C = max(1, int(counts.max()))
    inc = np.zeros((Z, C), np.int64)
    inc_ok = np.zeros((Z, C), bool)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for z in np.flatnonzero(counts):
        n = counts[z]
        inc[z, :n] = flat[order[starts[z]:starts[z] + n]]
        inc_ok[z, :n] = True
    return inc, inc_ok


def _scatter(vals: torch.Tensor, inc: torch.Tensor, inc_ok: torch.Tensor) -> torch.Tensor:
    """Per-zeta sums of local blocks vals [R, S, 6] -> [Z, 6]: the
    reference's ``zeros.at[zidx].add(vals)`` as a gather and a sum over
    the incidence table's fixed order (deterministic on every device)."""
    g = vals.reshape(-1, vals.shape[-1])[inc]  # [Z, C, 6]
    return torch.where(inc_ok[..., None], g, 0.0).sum(dim=1)


def prefix_band(Ts: torch.Tensor, width: int) -> torch.Tensor:
    """The first ``width`` diagonals of ``se3.prefix_products(Ts)``:
    ``band[d, j] = Ts[j+d] @ ... @ Ts[j]`` (the dense table's entry
    [j, j+d]), built as ``width - 1`` batched products in the dense
    table's order (``carry = Ts[k] @ carry``); entries with j + d >= Z are
    identity. Ts [Z, 4, 4] -> [width, Z, 4, 4]."""
    Z = Ts.shape[0]
    eye = torch.eye(4, dtype=Ts.dtype, device=Ts.device)
    rows = [Ts]
    for d in range(1, width):
        prod = Ts[d:] @ rows[-1][: max(Z - d, 0)]
        rows.append(torch.cat([prod, eye.expand(min(d, Z), 4, 4)]))
    return torch.stack(rows)


def _band_at(band: torch.Tensor, j: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The dense prefix table's entry [j, k] from its band (k - j < width):
    the sub-chain product for j <= k, identity for j > k."""
    W_, Z = band.shape[:2]
    d = k - j
    T = band[torch.clamp(d, 0, W_ - 1), torch.clamp(j, 0, Z - 1)]
    eye = torch.eye(4, dtype=band.dtype, device=band.device)
    return torch.where((d >= 0)[..., None, None], T, eye)


def _compose(band: torch.Tensor, reps: torch.Tensor) -> torch.Tensor:
    """Composed pose per constraint [R, 4, 4]: the forward product over its
    span, inverted for a reversed constraint (z0 > z1)."""
    z0, z1 = reps[:, 0], reps[:, 1]
    T_fwd = _band_at(band, torch.minimum(z0, z1), torch.maximum(z0, z1))
    return torch.where((z0 > z1)[:, None, None], se3.inverse(T_fwd), T_fwd)


def _local_system(T0s, reps, zidx, zmask, wreps, p, p_t, huber_delta, pmask, width):
    """Residuals and *local* Jacobian blocks of the constraints.

    Returns (r [R, N], J [R, N, S, 6]) pre-weighted.
    """
    Z = T0s.shape[0]
    band = prefix_band(T0s, width)

    z0 = reps[:, 0]
    z1 = reps[:, 1]
    rev = z0 > z1
    r = epipolar.residual_from_T(_compose(band, reps), p, p_t, huber_delta, pmask)
    r = r * wreps[:, None]

    # Tl/Tr per (constraint, span slot): the dispatch of optim.lm over the
    # S-wide local span.
    k = zidx  # [R, S] global zeta ids
    z0g = z0[:, None].expand(k.shape)
    z1g = z1[:, None].expand(k.shape)
    eye = torch.eye(4, dtype=T0s.dtype, device=T0s.device)
    Tl_f = _band_at(band, k, torch.maximum(z1g, k))
    Tr_f = torch.where((k > z0g)[..., None, None],
                       _band_at(band, z0g, torch.clamp(k - 1, min=0)), eye)
    Tl_r = se3.inverse(_band_at(band, z1g, torch.maximum(k, z1g)))
    Tr_r = torch.where((k < z0g)[..., None, None],
                       se3.inverse(_band_at(band, torch.clamp(k + 1, max=Z - 1), z0g)),
                       eye)
    rev_b = rev[:, None, None, None]
    Tl = torch.where(rev_b, Tl_r, Tl_f)
    Tr = torch.where(rev_b, Tr_r, Tr_f)

    pm = pmask if pmask is not None else torch.ones(p.shape[:2], dtype=torch.bool,
                                                    device=p.device)
    # Broadcast over [R, S]: the points are shared by the slots of one
    # constraint.
    J = epipolar.residual_jacobian(Tl, Tr, p[:, None], p_t[:, None], rev[:, None],
                                   huber_delta, pm[:, None])  # [R, S, N, 6]
    J = J.transpose(1, 2)  # [R, N, S, 6]
    J = J * zmask[:, None, :, None] * wreps[:, None, None, None]
    return r, J


def _matvec(J, zidx, v, inc, inc_ok):
    """Damped-Gauss-Newton matvec: (J^T J) v with local blocks.

    J [R, N, S, 6]; v [Z, 6]. Returns [Z, 6].
    """
    v_loc = v[zidx]  # [R, S, 6]
    Jv = torch.einsum("rnsk,rsk->rn", J, v_loc)
    return _scatter(torch.einsum("rnsk,rn->rsk", J, Jv), inc, inc_ok)


def _rhs_and_diag(J, r, inc, inc_ok):
    b = _scatter(torch.einsum("rnsk,rn->rsk", J, r), inc, inc_ok)
    diag = _scatter(torch.einsum("rnsk,rnsk->rsk", J, J), inc, inc_ok)
    return b, diag


def _pcg(matvec, b, diag, lam, iters):
    """Jacobi-preconditioned CG for (JtJ + lam*diag(JtJ) + eps) x = -b,
    ``iters`` iterations."""
    damp = lam * diag + 1e-7 * (torch.mean(diag) + 1e-30)

    def A(v):
        return matvec(v) + damp * v

    Minv = 1.0 / torch.clamp(diag + damp, min=1e-30)
    x = torch.zeros_like(b)
    r = -b  # residual of A x + b = 0 at x=0
    z = Minv * r
    p_dir = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = A(p_dir)
        alpha = rz / torch.clamp(torch.sum(p_dir * Ap), min=1e-30)
        x = x + alpha * p_dir
        r = r - alpha * Ap
        z = Minv * r
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_dir = z + beta * p_dir
        rz = rz_new
    return x


def global_ba_solve(
    T0s: torch.Tensor,
    reps: np.ndarray,
    p: torch.Tensor,
    p_t: torch.Tensor,
    wreps: torch.Tensor | None = None,
    pmask: torch.Tensor | None = None,
    max_span: int = 4,
    lambda0: float = 1e-2,
    max_iters: int = 20,
    cg_iters: int = 32,
    huber_delta: float = 1.0,
    mesh=None,
) -> GlobalBAResult:
    """Joint LM over the full zeta chain, on T0s's device with no host sync.

    Args:
      T0s: [Z, 4, 4] initial chain.
      reps: [R, 2] spans (|z1 - z0| + 1 <= max_span; numpy, static).
      p, p_t: [R, N, 3] matches; wreps [R]; pmask [R, N].
      mesh: a ``DeviceMesh`` (``parallel.mesh.make_mesh``) built for T0s's
        device: R is sharded over its ``win`` axis and must divide evenly
        (pad with zero-weight constraints); every rank passes the whole
        arrays and gets the same result.

    Each of the ``max_iters`` LM iterations accepts its step when the
    energy falls (lambda / 2) and rejects it otherwise (lambda x 5), with
    a NaN guard; ``r_norm`` is the square root of the last accepted
    energy.
    """
    Z = T0s.shape[0]
    dtype, dev = T0s.dtype, T0s.device
    reps_np = np.asarray(reps, np.int32)
    w = (torch.ones(reps_np.shape[0], dtype=dtype, device=dev) if wreps is None
         else wreps.to(device=dev, dtype=dtype))
    pm = pmask if pmask is not None else torch.ones(p.shape[:2], dtype=torch.bool,
                                                    device=dev)
    if mesh is not None:
        mesh_mod.check_mesh(mesh, dev)
        R = reps_np.shape[0]
        if R % mesh_mod.axis_size(mesh, "win"):
            raise ValueError(f"constraint count {R} must divide the mesh axis 'win' "
                             f"({mesh_mod.axis_size(mesh, 'win')}); pad with "
                             f"zero-weight constraints")
        lo, hi = mesh_mod.block(R, mesh, "win")
        reps_np, p, p_t, w, pm = reps_np[lo:hi], p[lo:hi], p_t[lo:hi], w[lo:hi], pm[lo:hi]
    psum = lambda x: mesh_mod.psum(x, mesh, "win")
    zidx_np, zmask_np = _span_data(reps_np, max_span)
    inc_np, inc_ok_np = _incidence(zidx_np, zmask_np, Z)
    reps_t = constant(reps_np.astype(np.int64), torch.int64, dev)
    zidx = constant(zidx_np.astype(np.int64), torch.int64, dev)
    zmask = constant(zmask_np, torch.bool, dev)
    inc = constant(inc_np, torch.int64, dev)
    inc_ok = constant(inc_ok_np, torch.bool, dev)

    def energy(Ts):
        T0r = _compose(prefix_band(Ts, max_span), reps_t)
        r = epipolar.residual_from_T(T0r, p, p_t, huber_delta, pm)
        return psum(torch.sum((r * w[:, None]) ** 2))

    Ts = T0s
    lam = torch.full((), lambda0, dtype=dtype, device=dev)
    prev_E = energy(T0s)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        r, J = _local_system(Ts, reps_t, zidx, zmask, w, p, p_t, huber_delta, pm,
                             max_span)
        b, diag = psum(torch.stack(_rhs_and_diag(J, r, inc, inc_ok)))
        delta = _pcg(lambda v: psum(_matvec(J, zidx, v, inc, inc_ok)), b, diag, lam,
                     cg_iters)  # [Z, 6]
        bad = ~torch.all(torch.isfinite(delta))
        delta = torch.where(bad, 0.0, delta)
        Ts_cand = torch.einsum("zij,zjk->zik", Ts, se3.se3_exp(delta))
        cand_E = energy(Ts_cand)
        accept = (cand_E < prev_E) & ~bad
        Ts = torch.where(accept, Ts_cand, Ts)
        lam = torch.where(accept, lam / 2.0, lam * 5.0)
        prev_E = torch.where(accept, cand_E, prev_E)
        n_acc = n_acc + accept.to(torch.int32)
    return GlobalBAResult(T0s=Ts, r_norm=torch.sqrt(prev_E), n_accepted=n_acc, lam=lam)
