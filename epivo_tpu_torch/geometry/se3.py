"""Batched SE(3) / SO(3) operations (port of ``epivo_tpu/geometry/se3.py``).

Closed-form, branch-free tensor math over arbitrary leading batch
dimensions. Poses are 4x4 homogeneous matrices. Tangent vectors are
``xi = (v, w)``: translation first, rotation second.
"""

from __future__ import annotations

import torch

# Small-angle cutoff: below this, Taylor expansions are used.
_EPS = 1e-6


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3).

    Branch-free small-angle handling: Taylor series below the cutoff. The
    guarded lanes are overwritten by ``where``, so forward-mode AD through
    theta2 = 0 stays finite. Callers pass theta2 with a trailing axis of
    size 1: ``torch.func.jacfwd`` promotes the tangent of a 0-dim tensor
    times a Python float to float64.
    """
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe_t - torch.sin(safe_t)) / (safe_t2 * safe_t))
    return A, B, C


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3_like(W) + A[..., None] * W + B[..., None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3): [..., 3, 3] -> [..., 3] axis-angle (accurate away
    from theta = pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_vee = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta = torch.sin(theta)
    small = theta < 1e-4
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    factor = torch.where(small, 1.0 + theta * theta / 6.0, theta / safe_sin)
    return w_vee * factor[..., None]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: [..., 6] (v, w) -> [..., 4, 4]."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    A, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = _eye3_like(W)
    R = eye + A[..., None] * W + B[..., None] * W2
    V = eye + B[..., None] * W + C[..., None] * W2
    t = torch.einsum("...ij,...j->...i", V, v)
    return rt_to_matrix(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: [..., 4, 4] -> [..., 6] (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    small = theta2 < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / safe_t2,
    )
    V_inv = _eye3_like(W) - 0.5 * W + coef[..., None] * W2
    v = torch.einsum("...ij,...j->...i", V_inv, t)
    return torch.cat([v, w], dim=-1)


def rt_to_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble [..., 4, 4] homogeneous transforms from R [...,3,3], t [...,3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    # Row 3 of the identity: no host-to-device copy, so no stream sync.
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_rt(T: torch.Tensor):
    """Split [..., 4, 4] -> (R [...,3,3], t [...,3])."""
    return T[..., :3, :3], T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse (never a linear solve)."""
    R, t = matrix_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_matrix(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch_shape) + (4, 4))


def mul44(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 4x4 matrix product as broadcast-multiply + sum (the
    reference's summation form, kept so both packages round alike)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def generators(dtype=torch.float32, device=None) -> torch.Tensor:
    """The 6 generators of se(3) as a [6, 4, 4] tensor, order (v, w).

    Built from identity rows, not by item assignment: on a CUDA tensor,
    assigning a Python number copies it from the host with a stream sync.
    """
    e = torch.eye(4, dtype=dtype, device=device)
    # Translation generators: e_k in the last column.
    trans = e[:3, :, None] * e[3][None, None, :]
    # Rotation generators: hat(e_k) in the top-left 3x3 block.
    rot = torch.nn.functional.pad(hat(e[:3, :3]), (0, 1, 0, 1))
    return torch.cat([trans, rot])


def chain_compose(Ts: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Compose a chain of transforms [n, 4, 4]: returns T[n-1] @ ... @ T[0]
    (``carry @ T`` order when ``reverse``)."""
    out = torch.eye(4, dtype=Ts.dtype, device=Ts.device)
    for T in Ts:
        out = T @ out if not reverse else out @ T
    return out


def prefix_products(Ts: torch.Tensor) -> torch.Tensor:
    """All contiguous sub-chain products of a pose chain.

    ``out[..., j, k] = Ts[k] @ Ts[k-1] @ ... @ Ts[j]`` for ``j <= k``;
    entries with ``j > k`` are identity. ``Ts`` is [..., Z, 4, 4] (leading
    axes are windows or pairs); output [..., Z, Z, 4, 4]. Z is a window
    size (a handful), so a plain double loop over Z, never over the
    leading axes.
    """
    Z = Ts.shape[-3]
    eye = torch.eye(4, dtype=Ts.dtype, device=Ts.device).expand(Ts.shape[:-3] + (4, 4))
    rows = []
    for j in range(Z):
        row = [eye] * j
        carry = Ts[..., j, :, :]
        row.append(carry)
        for k in range(j + 1, Z):
            carry = Ts[..., k, :, :] @ carry
            row.append(carry)
        rows.append(torch.stack(row, dim=-3))
    return torch.stack(rows, dim=-4)
