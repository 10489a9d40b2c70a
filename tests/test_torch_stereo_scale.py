"""Port parity: the stereo runner's metric scale, on inputs where the
JAX package's own tests and the rendered fixture do not reach it.

- The EuRoC-style misaligned rig (the twin of
  ``test_euroc_style_rectified_stereo_ba`` in
  ``tests/test_runners_datasets.py``), rectified by the port's
  ``stereo_rectify`` (equal to the reference's maps, rig and rotation) and
  ``remap``, run through the port's ``run_stereo_ba_sequence``: every
  metric step within rtol 0.3 of the ground truth, ATE below 0.25.
- Both packages' back halves (extraction replaced) on pairs of known
  geometry where the f64 refinement converges on every step: pass 1's
  inits, pass 2's refined scales, the scale used per step and the
  post-LM rescale's scales within 1e-5, Hampel flags and window weights
  equal, window initial poses within 1e-5, trajectories within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.datasets import euroc as jeuroc
from epivo_tpu.geometry import se3 as jse3
from epivo_tpu.pipeline import runners as jrunners, scale as jscale
from epivo_tpu_torch.datasets import euroc as teuroc
from epivo_tpu_torch.pipeline import runners as trunners
from tests.test_pipeline import render
from tests.test_runners_datasets import CAM
from tests.test_torch_stereo import CFG, TCFG, _metric_bounds, _recording, _same_nan, _steps

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)


def test_euroc_style_rectified_stereo_ba():
    """The twin of the reference test of that name, on the port: a
    misaligned rig, rectified by the port's ``stereo_rectify`` and
    ``remap``, gives the metric scale with no GT fed."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    z = jax.random.uniform(k1, (140,), minval=6.0, maxval=18.0)
    xy = jax.random.uniform(k2, (140, 2), minval=-0.7, maxval=0.7) * z[:, None]
    X = np.asarray(jnp.concatenate([xy, z[:, None]], axis=-1))
    K = np.asarray(CAM.K(), np.float64)
    H, W = 120, 160
    th = np.deg2rad(1.0)
    T_BS1 = np.eye(4)
    T_BS1[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                              [-np.sin(th), 0, np.cos(th)]])
    T_BS1[:3, 3] = [0.5, 0.0, 0.0]
    args = (K, np.zeros(4), np.eye(4), K, np.zeros(4), T_BS1, (H, W))
    maps0, maps1, K_new, T_rig, Rrect0 = teuroc.stereo_rectify(*args)
    for a, b in zip((maps0, maps1, K_new, T_rig, Rrect0), jeuroc.stereo_rectify(*args)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    T_rel = np.linalg.inv(T_BS1)
    step = np.asarray(jse3.se3_exp(jnp.array([0.02, -0.01, 0.35, 0.006, -0.01, 0.004])))
    L, R, gt = [], [], []
    T_wb = np.eye(4)
    for _ in range(4):
        T_bw = np.linalg.inv(T_wb)
        img0 = np.asarray(render(jnp.asarray(X), jnp.asarray(K),
                                 jnp.asarray(T_bw.astype(np.float32)), H, W))
        img1 = np.asarray(render(jnp.asarray(X), jnp.asarray(K),
                                 jnp.asarray((T_rel @ T_bw).astype(np.float32)), H, W))
        L.append(teuroc.remap(img0, *maps0))
        R.append(teuroc.remap(img1, *maps1))
        Text = np.eye(4)
        Text[:3, :3] = Rrect0.T
        gt.append(T_wb @ Text)
        T_wb = T_wb @ np.linalg.inv(step)
    res = trunners.run_stereo_ba_sequence(L, R, TCFG, T_rig=T_rig, gt_poses=np.stack(gt),
                                          device="cpu")
    _metric_bounds(res, 0.3, 0.25)


def _synthetic_stereo_pairs(F=7, n_pts=128, N=32, seed=11, baseline=0.5):
    """The stereo runner's pairs for F frames of known geometry, as
    ``_extract_pairs`` returns them: landmarks seen from every camera
    (doubled index, 2k = L_k, 2k+1 = R_k), exact source points, target
    points with numpy-seeded noise of ~0.3 px (fx 200), 5 % of the matches
    masked out, and unit-norm two-view poses with a rotation error of
    ~1e-3 rad. The forward steps vary by up to 20 %. Returns (pairs,
    gt [F, 4, 4] left camera-to-world, T_rig)."""
    rng = np.random.default_rng(seed)
    T_rig = np.eye(4)
    T_rig[0, 3] = -baseline
    gt, T_wc = [], np.eye(4)
    for k in range(F):
        gt.append(T_wc.copy())
        step = np.eye(4)
        step[:3, :3] = np.asarray(jse3.so3_exp(jnp.array([0.0, 0.01 * np.sin(k), 0.0])),
                                  np.float64)
        step[:3, 3] = [0.02, 0.0, 0.35 * (1 + 0.2 * np.sin(0.6 * k))]
        T_wc = T_wc @ step
    z = rng.uniform(6.0, 25.0, n_pts)
    Xw = np.stack([rng.uniform(-0.6, 0.6, n_pts) * z, rng.uniform(-0.4, 0.4, n_pts) * z,
                   z + 3.0], axis=1)

    def cam_from_world(i):
        T_cw = np.linalg.inv(gt[i // 2])
        return T_cw if i % 2 == 0 else T_rig @ T_cw

    def project(T_cw):
        X = Xw @ T_cw[:3, :3].T + T_cw[:3, 3]
        return np.concatenate([X[:, :2] / X[:, 2:], np.ones((n_pts, 1))], axis=1)

    pairs = {}
    for k in range(F - 1):
        for i, j in ((2 * k, 2 * k + 1), (2 * k, 2 * k + 2), (2 * k + 1, 2 * k + 2)):
            p0 = project(cam_from_world(i)).astype(np.float32)
            p1 = project(cam_from_world(j))
            p1[:, :2] += rng.normal(0, 1.5e-3, (n_pts, 2))
            T = cam_from_world(j) @ np.linalg.inv(cam_from_world(i))
            T[:3, 3] /= np.linalg.norm(T[:3, 3])
            T[:3, :3] = T[:3, :3] @ np.asarray(
                jse3.so3_exp(jnp.asarray(rng.normal(0, 1e-3, 3))), np.float64)
            sel = rng.uniform(size=n_pts) > 0.05
            take = np.argsort(~sel, kind="stable")[:N]
            p1 = p1.astype(np.float32)
            pairs[(i, j)] = dict(p=p0[take], p_t=p1[take], mask=sel[take],
                                 T=T.astype(np.float32), p_full=p0, p_t_full=p1,
                                 mask_full=sel, n_inl=int(sel.sum()), rev=False)
    return pairs, np.stack(gt), T_rig.astype(np.float32)


def test_back_halves_on_synthetic_pairs(monkeypatch):
    """Both packages' back halves on pairs of known geometry, where every
    step's f64 refinement converges: the scale passes and window
    initialization within 1e-5 (module docstring), the post-LM rescale's
    scales within 1e-5 and the trajectories within 1e-4 of each other;
    each step's metric length within 10 % of the ground truth (measured
    up to 5.9 %: 0.3 px of noise at depths up to 28 m on a 0.5 m baseline)."""
    pairs, gt, T_rig = _synthetic_stereo_pairs()
    F = gt.shape[0]
    frames = [np.zeros((8, 8), np.float32)] * F
    same = lambda *a, **k: {p: dict(d) for p, d in pairs.items()}
    hampel, solve_j, solve_t = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunners, "_extract_pairs", same)
        _recording(mp, jscale, "hampel_log", hampel)
        _recording(mp, jrunners, "_solve_windows", solve_j)
        res_j = jrunners.run_stereo_ba_sequence(frames, frames, CFG, T_rig=T_rig,
                                                gt_poses=gt)
    ss = trunners.stereo_step_scales(pairs, F, T_rig, TCFG, device="cpu")
    assert ss.refined.all() and ss.ks == list(range(F - 1))
    for got, (args, _, (out, rep)), flags in ((ss.s0, hampel[0], ss.replaced0),
                                             (ss.s_refined, hampel[1], ss.replaced1)):
        _same_nan(got, args[0], 1e-5)
        np.testing.assert_array_equal(flags, rep)
    _same_nan(ss.scale, hampel[1][2][0], 1e-5)

    monkeypatch.setattr(trunners, "_extract_pairs", same)
    post = []
    _recording(monkeypatch, trunners.scale_mod, "hampel_log", post)
    _recording(monkeypatch, trunners, "_solve_windows", solve_t)
    res = trunners.run_stereo_ba_sequence(frames, frames, TCFG, T_rig=T_rig, gt_poses=gt,
                                          device="cpu")
    np.testing.assert_allclose(solve_t[0][0][0], np.asarray(solve_j[0][0][0]), atol=1e-5)
    np.testing.assert_array_equal(solve_t[0][0][4], np.asarray(solve_j[0][0][4]))
    _same_nan(post[-1][0][0], hampel[-1][0][0], 1e-5)
    Tj, T = np.asarray(res_j.trajectory), res.trajectory
    np.testing.assert_allclose(T, Tj, atol=1e-4)
    for r in (res, res_j):
        np.testing.assert_allclose(_steps(r.trajectory), _steps(r.gt_trajectory), rtol=0.1)
