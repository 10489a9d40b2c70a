"""Trajectory evaluation: ATE / RPE with Umeyama alignment (port of
``epivo_tpu/eval/metrics.py``, plain numpy, copied)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class AlignResult(NamedTuple):
    scale: float
    R: np.ndarray  # [3, 3]
    t: np.ndarray  # [3]


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True) -> AlignResult:
    """Least-squares similarity transform aligning src -> dst ([N, 3] each)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        scale = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        scale = 1.0
    t = mu_d - scale * R @ mu_s
    return AlignResult(scale=scale, R=R, t=t)


def positions(traj: np.ndarray) -> np.ndarray:
    """[F, 4, 4] camera-to-world poses -> [F, 3] positions."""
    return np.asarray(traj)[:, :3, 3]


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True,
             with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE of positions after alignment).

    est/gt: [F, 4, 4] pose arrays or [F, 3] position arrays.
    """
    p_est = est if est.ndim == 2 else positions(est)
    p_gt = gt if gt.ndim == 2 else positions(gt)
    assert p_est.shape == p_gt.shape
    if align:
        a = umeyama(p_est, p_gt, with_scale=with_scale)
        p_est = (a.scale * (a.R @ p_est.T)).T + a.t
    err = np.linalg.norm(p_est - p_gt, axis=-1)
    return float(np.sqrt((err**2).mean()))


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1):
    """Relative pose error over frame gaps of ``delta``.

    Returns (trans_rmse, rot_rmse_rad). est/gt: [F, 4, 4].
    """
    est = np.asarray(est)
    gt = np.asarray(gt)
    F = est.shape[0]
    t_errs, r_errs = [], []
    for i in range(F - delta):
        dE = np.linalg.inv(est[i]) @ est[i + delta]
        dG = np.linalg.inv(gt[i]) @ gt[i + delta]
        dd = np.linalg.inv(dG) @ dE
        t_errs.append(np.linalg.norm(dd[:3, 3]))
        cos = np.clip((np.trace(dd[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_errs.append(np.arccos(cos))
    return (
        float(np.sqrt(np.mean(np.square(t_errs)))),
        float(np.sqrt(np.mean(np.square(r_errs)))),
    )
