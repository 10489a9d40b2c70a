"""The port's twins of the JAX package's imagery-level loop-closure tests
(``tests/test_loopclose.py``), each minutes long and marked slow: the
same rendered fixtures, configurations and assertions, through
``epivo_tpu_torch`` alone (no JAX import, so they also run on the GPU
machine with ``--noconftest``), on the CUDA card when there is one, else
on the CPU. The port draws its own RANSAC samples, so a twin holds the
port to the reference test's bounds, not to its numbers.

- ``test_close_loops_on_photoreal_fixture`` (reference :111);
- ``test_verify_loop_nonzero_baseline_recovers_norm`` (:216);
- ``test_relocalize_reanchors_after_collapse`` (:282);
- ``test_close_loops_joint_on_two_lap_fixture`` (:361; about 4 minutes
  in the reference, which does not mark it slow).

    python -m pytest tests/test_torch_loopclose_slow.py -m slow
"""

import dataclasses

import numpy as np
import pytest
import torch

from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.geometry import camera as cam_mod
from epivo_tpu_torch.pipeline import loopclose
from epivo_tpu_torch.pipeline.config import (
    BAConfig, FrontendConfig, LMConfig, LoopConfig, RansacConfig, VOConfig,
)

pytestmark = pytest.mark.slow

H, W, F_PX = 188, 620, 359.4
K = np.array([[F_PX, 0, W / 2.0], [0, F_PX, H / 2.0], [0, 0, 1.0]])
DEV = "cuda" if torch.cuda.is_available() else "cpu"


def _fixture(**traj):
    """(keyframes {idx: half-res uint8} at stride 8, gt) of the rendered
    loop course at 188x620, noise 1.0."""
    frames, gt, _ = photoreal.loop_sequence(H=H, W=W, K=K, noise_sigma=1.0, **traj)
    kf = {idx: loopclose.keyframe_half(f) for idx, f in enumerate(frames)
          if idx % 8 in (0, 1)}
    return kf, gt


def _config(**loop):
    return BAConfig(camera=cam_mod.Pinhole(F_PX, F_PX, W / 2.0, H / 2.0, W, H),
                    frontend=FrontendConfig(fast_threshold=25.0, max_keypoints=512),
                    ransac=RansacConfig(n_hyp=512), lm=LMConfig(n_points=32),
                    loop=LoopConfig(enabled=True, min_matches=30, min_inliers=25, **loop))


def _half(cfg, pyramid=False):
    c = cfg.camera
    return VOConfig(camera=cam_mod.Pinhole(c.fx / 2, c.fy / 2, c.cx / 2, c.cy / 2,
                                           c.width // 2, c.height // 2),
                    frontend=dataclasses.replace(cfg.frontend, orb_pyramid=pyramid),
                    ransac=cfg.ransac, lm=cfg.lm)


def _drifted(gt, xi, shrink=0.0):
    drift = loopclose.se3_exp_np(np.asarray(xi, np.float64))
    est = gt.copy().astype(np.float64)
    for k in range(1, len(est)):
        step = np.linalg.inv(gt[k - 1]) @ gt[k]
        step[:3, 3] *= np.exp(-shrink * k)
        est[k] = est[k - 1] @ step @ drift
    return est


def _ate(t, gt):
    return np.sqrt(((np.asarray(t)[:, :3, 3] - gt[:, :3, 3]) ** 2).sum(-1).mean())


def test_close_loops_on_photoreal_fixture():
    kf, gt = _fixture()
    est = _drifted(gt, [0.0, 0.0015, 0.0, 0.0, 0.0, 0.008])
    cfg = _config(min_gap=60)
    traj2, loops = loopclose.close_loops(est, kf, cfg, _half(cfg), seed=0, device=DEV)
    assert loops, "no loop detected+verified on the loop fixture"
    assert _ate(traj2, gt) < 0.7 * _ate(est, gt), (_ate(est, gt), _ate(traj2, gt), loops)


def test_verify_loop_nonzero_baseline_recovers_norm():
    gt = photoreal.loop_trajectory(close_offset=1.8)
    j = len(gt) - 6
    i = int(np.argmin(np.linalg.norm(gt[:40, :3, 3] - gt[j, :3, 3], axis=-1)))
    base_gt = float(np.linalg.norm((np.linalg.inv(gt[j]) @ gt[i])[:3, 3]))
    assert 1.2 < base_gt < 2.4, base_gt
    scene = photoreal.CorridorScene()
    tex = scene.textures()
    rng = np.random.default_rng(7)
    half = {k: loopclose.keyframe_half(photoreal.render_frame(
        scene, tex, K, gt[k], H, W, noise_sigma=1.0, rng=rng)).astype(np.float32)
        for k in (i, i + 1, j, j + 1)}
    vo_half = VOConfig(camera=cam_mod.Pinhole(F_PX / 2, F_PX / 2, W / 4.0, H / 4.0,
                                              W // 2, H // 2),
                       frontend=FrontendConfig(fast_threshold=25.0, max_keypoints=1024,
                                               orb_pyramid=True),
                       ransac=RansacConfig(n_hyp=512), lm=LMConfig(n_points=32))
    t_next = float(np.linalg.norm((np.linalg.inv(gt[i]) @ gt[i + 1])[:3, 3]))
    gen = torch.Generator(device=DEV).manual_seed(3)
    res = loopclose.verify_loop(half[i], half[j], half[i + 1], t_next, vo_half, gen,
                                device=DEV)
    assert res is not None and not res.zero_baseline
    norm = float(np.linalg.norm(res.T_meas[:3, 3]))
    assert abs(norm - base_gt) / base_gt < 0.3, (norm, base_gt)
    t_next_j = float(np.linalg.norm((np.linalg.inv(gt[j]) @ gt[j + 1])[:3, 3]))
    sigma = loopclose.measure_scale_drift(half[j], half[i], half[j + 1], t_next_j, norm,
                                          vo_half, torch.Generator(device=DEV).manual_seed(4),
                                          device=DEV)
    assert sigma is not None and 0.75 < sigma < 1.33, sigma


def test_relocalize_reanchors_after_collapse():
    kf, gt = _fixture()
    c = len(gt) - 30
    est = gt.copy().astype(np.float64)
    wrong = np.eye(4)
    wrong[:3, 3] = [6.0, 0.5, -9.0]  # teleported anchor
    est[c:] = wrong[None] @ gt[c:]
    cfg = _config(min_gap=0)
    pre_err = np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3])
    traj2, lp = loopclose.relocalize(est, kf, cfg, _half(cfg, pyramid=True), collapse_idx=c,
                                     seed=0, device=DEV)
    assert lp is not None, "no verified re-entry found"
    assert lp.j > c and lp.i + 1 < c
    post_err = np.linalg.norm(np.asarray(traj2)[-1, :3, 3] - gt[-1, :3, 3])
    assert pre_err > 5.0
    assert post_err < 0.3 * pre_err, (pre_err, post_err)
    np.testing.assert_allclose(np.asarray(traj2)[:c], gt[:c], atol=1e-5)


def test_close_loops_joint_on_two_lap_fixture():
    kf, gt = _fixture(laps=2)
    est = _drifted(gt, [0.0, 0.001, 0.0, 0.0, 0.0, 0.006], shrink=0.0012)
    cfg = _config(min_gap=60, max_loops=4)
    traj2, loops = loopclose.close_loops(est, kf, cfg, _half(cfg), seed=0, device=DEV)
    assert len(loops) >= 2, loops

    def length(t):
        return float(np.linalg.norm(np.diff(np.asarray(t, np.float64)[:, :3, 3], axis=0),
                                    axis=1).sum())

    assert _ate(traj2, gt) < 0.6 * _ate(est, gt), (_ate(est, gt), _ate(traj2, gt), loops)
    r_pre, r_post = length(est) / length(gt), length(traj2) / length(gt)
    assert abs(np.log(r_post)) < 0.6 * abs(np.log(r_pre)), (r_pre, r_post)
    cfg_g = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, pose_graph=False))
    _, loops_g = loopclose.close_loops(est, kf, cfg_g, _half(cfg), seed=0, device=DEV)
    assert len(loops_g) < len(loops), (loops_g, loops)
