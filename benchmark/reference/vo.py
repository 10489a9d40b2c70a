"""The two-view step and the VO sequence, plain: a frozen copy of the
port's ``pipeline/vo.py`` (``_klt_matches`` and ``_two_view_tail``) and of
the host half of ``pipeline/runners.py::run_vo_sequence``.

    images -> FAST -> KLT -> RANSAC / LMedS essential -> refine E
           -> recoverPose -> fallback -> top-N cheirality-passing inliers
           -> LM -> revert-on-uncertainty -> unit translation -> triangulation

:func:`step` takes the RANSAC uniforms themselves (the benchmark draws them
again from the seed), so it follows the program's draws without its
generator.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark.reference import camera as cam, epipolar, essential, fast, klt, lm, se3
from benchmark.reference import ransac as ransac_mod


@dataclasses.dataclass(frozen=True)
class VOSettings:
    """The settings of a ``kitti00_vo``-style configuration file."""

    camera: cam.Pinhole
    fast_threshold: float
    max_keypoints: int
    klt_window: int
    klt_levels: int
    klt_iters: int
    klt_min_eig: float
    n_hyp: int
    method: str
    threshold_px: float
    refine_e: bool
    refine_iters: int
    lambda0: float
    epsilon: float
    max_iters: int
    huber_delta: float
    n_points: int
    min_points: int
    revert_r_norm: float

    @staticmethod
    def from_config(cfg: dict) -> "VOSettings":
        c = cfg["camera"]
        return VOSettings(camera=cam.Pinhole(c["fx"], c["fy"], c["cx"], c["cy"],
                                             c["width"], c["height"]),
                          **cfg["frontend"], **cfg["ransac"], **cfg["lm"])


FIELDS = ("T", "n_tracked", "n_inliers", "r_norm", "reverted", "points", "points_valid",
          "matches_src", "matches_tgt", "inlier_mask")


@contextlib.contextmanager
def precision(lowp: bool):
    """TF32 in every float32 matmul and einsum while ``lowp``; the port's
    full float32 otherwise (its own setting, restored on exit)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = lowp
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _unit_translation(T: torch.Tensor) -> torch.Tensor:
    t = T[..., :3, 3]
    n = torch.linalg.norm(t, dim=-1, keepdim=True)
    safe = torch.where(n > 1e-12, n, 1.0)
    out = T.clone()
    out[..., :3, 3] = t / safe
    return out


def _select_top(mask: torch.Tensor, k: int):
    """Indices of the first k True lanes of the last axis, and their
    validity."""
    order = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)
    idx = order[..., :k]
    return idx, torch.gather(mask, -1, idx)


def n_keypoints(s: VOSettings) -> int:
    """The K of a step's result (the draw's last axis)."""
    return fast.n_keypoints(s.camera.height, s.camera.width, s.max_keypoints)


def step(img0: torch.Tensor, img1: torch.Tensor, uniforms: torch.Tensor, s: VOSettings,
         lowp: bool = False) -> dict:
    """B two-view steps: img0/img1 [B, H, W] float32, ``uniforms`` [B, n_hyp,
    K] the draw behind the RANSAC samples. Returns the fields of the port's
    ``VOStepResult`` (:data:`FIELDS`), each with a leading [B]. ``lowp``
    runs every matmul and einsum in TF32."""
    with precision(lowp):
        K_inv = s.camera.K_inv(img0.dtype, img0.device)
        kp = fast.detect(img0, s.fast_threshold, s.max_keypoints)
        flow = klt.track(img0, img1, kp.xy, valid=kp.valid, win=s.klt_window,
                         levels=s.klt_levels, iters=s.klt_iters, min_eig=s.klt_min_eig)
        status = flow.status
        n_tracked = torch.sum(status, dim=-1).to(torch.int32)
        p0 = cam.normalize(kp.xy, K_inv)
        p1 = cam.normalize(flow.xy, K_inv)

        thr = (s.threshold_px / s.camera.fx) ** 2
        rres = ransac_mod.ransac_essential(uniforms, p0, p1, threshold=thr, mask=status,
                                           method=s.method)
        E = rres.E
        if s.refine_e:
            E = essential.refine_essential(E, p0, p1, mask=rres.inliers, iters=s.refine_iters)
        R_e, t_e, front = essential.recover_pose(E, p0, p1, mask=rres.inliers)
        R_e, t_e = essential.pose_fallback(R_e, t_e)
        T_e = se3.rt_to_matrix(R_e, t_e)

        sel = rres.inliers & front & status
        idx, sel_valid = _select_top(sel, s.n_points)
        pick = lambda q: torch.gather(q, 1, idx[..., None].expand(-1, -1, 3))[:, None]
        out = lm.solve_batched(
            T_e[:, None], torch.zeros((1, 2), dtype=torch.int64, device=img0.device),
            pick(p0), pick(p1), pmask=sel_valid[:, None], lambda0=s.lambda0,
            epsilon=s.epsilon, max_iters=s.max_iters, huber_delta=s.huber_delta)
        enough = torch.sum(sel_valid, dim=-1) >= s.min_points
        revert = (out.r_norm > s.revert_r_norm) | ~enough
        T = _unit_translation(torch.where(revert[:, None, None], T_e, out.T0s[:, 0]))
        R, t = se3.matrix_to_rt(T)
        pts, pts_valid = epipolar.triangulate(R, t, p0, p1)
        track_inl = status & rres.inliers
        return dict(T=T, n_tracked=n_tracked, n_inliers=rres.n_inliers, r_norm=out.r_norm,
                    reverted=revert, points=pts, points_valid=pts_valid & track_inl,
                    matches_src=kp.xy, matches_tgt=flow.xy, inlier_mask=track_inl)


def trajectory(dTs: np.ndarray) -> np.ndarray:
    """The runner's trajectory from its relative poses [F, 4, 4] with no
    ground truth (unit steps): cT_{i+1} = cT_i @ inv(dT_i) from the
    identity, in float32 as the runner chains them."""
    dT = torch.from_numpy(np.asarray(dTs, np.float32))
    t = dT[:, :3, 3]
    unit = dT.clone()
    unit[:, :3, 3] = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)
    cT = torch.eye(4)
    traj = [cT]
    for d in unit:
        cT = cT @ se3.inverse(d)
        traj.append(cT)
    return torch.stack(traj).numpy()


def world_cloud(traj: np.ndarray, points: np.ndarray, valid: np.ndarray):
    """The runner's cloud: each pair's valid points [B, K, 3] (source camera
    frame) in the world, concatenated, and each pair's start offset."""
    clouds = [points[i][valid[i]] @ traj[i][:3, :3].T + traj[i][:3, 3]
              for i in range(points.shape[0])]
    counts = np.asarray([len(c) for c in clouds], np.int64)
    return np.concatenate(clouds), np.concatenate([[0], np.cumsum(counts)[:-1]])
