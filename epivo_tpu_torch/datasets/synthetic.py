"""Synthetic SE(3) scene/sequence generator (port of
``epivo_tpu/datasets/synthetic.py``).

The reference's test harness `sequence.hpp` (`gen_T:10-29`,
`gen_sequence:31-37`, `T_noise:39-50`, `noise_sequence:52-62`,
`gen_points:64-104`, `gen_scene_sequence:106-159`): random bounded-rotation
pose chains, calibrated perturbations, and visible-point sampling with known
ground truth, used for GT-recovery property tests of the optimizer.

Every function draws from an explicit ``torch.Generator`` (in place of the
JAX package's ``jax.random`` keys) and builds its tensors on the
generator's device, so a seed gives the same scene on every call. The
draws are not ``jax.random``'s: the two packages give different scenes of
the same distribution. As in the JAX package, points are not
rejection-sampled (`sequence.hpp:83-90`): depths are drawn in a visible
band of the target frame and lifted back to the source frame.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from epivo_tpu_torch.geometry import se3


class SceneSequence(NamedTuple):
    """A synthetic multi-reprojection scene with ground truth.

    Mirrors the outputs of `gen_scene_sequence` (`sequence.hpp:106-159`).
    """

    Ts: torch.Tensor  # [Z, 4, 4] ground-truth zeta poses (frame j -> j+1)
    T0s: torch.Tensor  # [Z, 4, 4] perturbed initialization
    reps: np.ndarray  # [R, 2] (z0, z1) zeta spans (static metadata)
    p: torch.Tensor  # [R, N, 3] source points (normalized homogeneous)
    p_t: torch.Tensor  # [R, N, 3] target points
    X: torch.Tensor  # [R, N, 3] landmark positions in the source frame


def _uniform(generator: torch.Generator, shape, lo: float, hi: float,
             dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return lo + (hi - lo) * u


def _axis_rotations(angles: torch.Tensor) -> torch.Tensor:
    """Rx(a0) @ Ry(a1) @ Rz(a2) for angles [3]."""
    eye = torch.eye(3, dtype=angles.dtype, device=angles.device)
    Rx, Ry, Rz = (se3.so3_exp(eye[k] * angles[k]) for k in range(3))
    return Rx @ Ry @ Rz


def random_pose(generator: torch.Generator, max_angle: float = np.pi / 6,
                t_scale: float = 2.0, dtype=torch.float32) -> torch.Tensor:
    """One random pose: per-axis rotations bounded by ``max_angle``,
    translation in [-s, s]^3 with positive z (ref `gen_T`, `sequence.hpp:10-29`)."""
    angles = _uniform(generator, (3,), -max_angle, max_angle, dtype)
    t = _uniform(generator, (3,), -t_scale, t_scale, dtype)
    t = torch.cat([t[:2], t[2:].abs()])
    return se3.rt_to_matrix(_axis_rotations(angles), t)


def random_sequence(generator: torch.Generator, n: int,
                    dtype=torch.float32) -> torch.Tensor:
    return torch.stack([random_pose(generator, dtype=dtype) for _ in range(n)])


def perturb_pose(generator: torch.Generator, T: torch.Tensor, rot_noise: float = 0.05,
                 t_noise: float = 0.1) -> torch.Tensor:
    """T @ T_noise with bounded rotation/translation noise
    (ref `T_noise`/`noise_sequence`, `sequence.hpp:39-62`)."""
    angles = _uniform(generator, (3,), -rot_noise, rot_noise, T.dtype)
    tn = _uniform(generator, (3,), -t_noise, t_noise, T.dtype)
    return T @ se3.rt_to_matrix(_axis_rotations(angles), tn)


def perturb_sequence(generator: torch.Generator, Ts: torch.Tensor,
                     rot_noise: float = 0.05, t_noise: float = 0.1) -> torch.Tensor:
    return torch.stack([perturb_pose(generator, T, rot_noise, t_noise) for T in Ts])


def gen_points(generator: torch.Generator, N: int, T: torch.Tensor,
               depth_range=(12.0, 40.0), pixel_noise: float = 0.0):
    """Sample N landmarks visible in both views of relative pose T.

    Target-frame points with depth in ``depth_range`` (all beyond the
    reference's z' > 10 gate, `sequence.hpp:81-91`), lifted back to the
    source frame; a point that lands behind the source camera takes the
    mirrored lateral position (z' unchanged). Returns
    (X [N,3] source-frame points, p [N,3], p_t [N,3]).
    """
    dtype = T.dtype
    R, t = se3.matrix_to_rt(T)
    z_t = _uniform(generator, (N,), depth_range[0], depth_range[1], dtype)
    xy_t = _uniform(generator, (N, 2), -0.6, 0.6, dtype) * z_t[:, None]
    X_t = torch.cat([xy_t, z_t[:, None]], dim=-1)
    # Back to the source frame: X = R^T (X_t - t).
    X = torch.einsum("ji,nj->ni", R, X_t - t)
    bad = X[:, 2] <= 1e-3
    X_t_flipped = torch.cat([-xy_t, z_t[:, None]], dim=-1)
    X_flip = torch.einsum("ji,nj->ni", R, X_t_flipped - t)
    X = torch.where(bad[:, None], X_flip, X)
    X_t = torch.where(bad[:, None], X_t_flipped, X_t)

    p = X / X[:, 2:3]
    p_t = X_t / X_t[:, 2:3]
    if pixel_noise > 0.0:
        noise = torch.randn((N, 2, 2), generator=generator, dtype=dtype,
                            device=generator.device) * pixel_noise
        p = torch.cat([p[:, :2] + noise[:, 0], p[:, 2:]], dim=-1)
        p_t = torch.cat([p_t[:, :2] + noise[:, 1], p_t[:, 2:]], dim=-1)
    return X, p, p_t


def compose_span(Ts: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
    """Composed relative pose over a zeta span, forward or reversed
    (ref `gen_scene_sequence`, `sequence.hpp:143-151`)."""
    out = torch.eye(4, dtype=Ts.dtype, device=Ts.device)
    if z0 <= z1:
        for j in range(z0, z1 + 1):
            out = Ts[j] @ out
    else:
        for j in range(z0, z1 - 1, -1):
            out = se3.inverse(Ts[j]) @ out
    return out


def gen_scene_sequence(
    generator: torch.Generator,
    N: int,
    n_zeta: int,
    reps: Sequence[Tuple[int, int]],
    rot_noise: float = 0.05,
    t_noise: float = 0.1,
    pixel_noise: float = 0.0,
    dtype=torch.float32,
) -> SceneSequence:
    """Full synthetic scene: GT chain, perturbed init, per-rep point matches,
    all drawn from ``generator`` on its device."""
    reps = np.asarray(reps, dtype=np.int32).reshape(-1, 2)
    for z0, z1 in reps:
        assert 0 <= z0 < n_zeta and 0 <= z1 < n_zeta
    Ts = random_sequence(generator, n_zeta, dtype=dtype)
    T0s = perturb_sequence(generator, Ts, rot_noise, t_noise)
    Xs, ps, pts = [], [], []
    for z0, z1 in reps:
        X, p, p_t = gen_points(generator, N, compose_span(Ts, int(z0), int(z1)),
                               pixel_noise=pixel_noise)
        Xs.append(X)
        ps.append(p)
        pts.append(p_t)
    return SceneSequence(Ts=Ts, T0s=T0s, reps=reps, p=torch.stack(ps),
                         p_t=torch.stack(pts), X=torch.stack(Xs))
