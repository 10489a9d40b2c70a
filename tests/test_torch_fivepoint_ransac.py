"""Port parity: RANSAC and the two-view step with the 5-point solver
(``ransac_essential(solver="5pt")``, ``vo_step`` with
``RansacConfig(solver="5pt")``).

The reference's 5-point solver compiles for minutes under ``jax.jit`` on
the CPU, so its ``ransac_essential`` runs eagerly here, once per method
(the ``reference`` fixture), on the reference's own samples
(``_sample_indices(key, n_hyp, N, mask, 5)``), which are injected into
the port. Tolerances, as for the 8-point solver
(``tests/test_torch_essential_ransac_lm.py``): inlier masks equal on
>= 99 % of the matches, n_inliers within 1 %, E up to sign within 1e-4,
the score within 1e-3 relative (LMedS: on the threshold's scale).

Port-only twins: the high-outlier comparison of
``tests/test_fivepoint.py:82-122`` (5-point RANSAC beats 8-point at 60 %
and 70 % outliers, N = 128, 384 hypotheses, 5 seeds), and ``vo_step``
with the 5-point solver on the small rendered corridor pairs of
``tests/test_torch_vo_batched.py`` against the ground truth, with B = 2
against single steps on the same samples.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu import ransac as jransac
from epivo_tpu.datasets import photoreal as jphotoreal
from epivo_tpu.pipeline import config as jconfig
from epivo_tpu_torch import convert, ransac as transac
from epivo_tpu_torch.datasets import synthetic as tsynth
from epivo_tpu_torch.geometry import essential as tess
from epivo_tpu_torch.pipeline import config as tconfig, vo as tvo
from tests.test_torch_essential_ransac_lm import _scene, _t, _up_to_sign
from tests.test_torch_vo_batched import HS, WS, _assert_step_close, _dir

# Parallel test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

N_HYP = 64
THR = (1.0 / 300.0) ** 2


@pytest.fixture(scope="module")
def scene():
    T, p, p_t = _scene(4)
    mask = np.random.default_rng(5).uniform(size=len(p)) > 0.1
    key = jax.random.PRNGKey(3)
    idx = np.asarray(jransac._sample_indices(key, N_HYP, len(p), jnp.asarray(mask), 5))
    return T, p, p_t, mask, key, idx


@pytest.mark.parametrize("method", ["ransac", "lmeds"])
def test_ransac_5pt_with_reference_samples(scene, method):
    T, p, p_t, mask, key, idx = scene
    res_j = jransac.ransac_essential(key, jnp.asarray(p), jnp.asarray(p_t), n_hyp=N_HYP,
                                     threshold=THR, mask=jnp.asarray(mask), method=method,
                                     solver="5pt")
    samples = convert.ransac_samples_from_reference(idx)
    assert samples.shape == (N_HYP, 5)
    res_t = transac.ransac_essential(None, _t(p), _t(p_t), n_hyp=N_HYP, threshold=THR,
                                     mask=torch.from_numpy(mask), method=method,
                                     solver="5pt", samples=samples)
    assert np.mean(np.asarray(res_j.inliers) == res_t.inliers.numpy()) >= 0.99
    assert abs(int(res_t.n_inliers) - int(res_j.n_inliers)) <= max(1, len(p) // 100)
    _up_to_sign(res_t.E.numpy(), res_j.E, 1e-4)
    np.testing.assert_allclose(float(res_t.best_score), float(res_j.best_score),
                               rtol=1e-3, atol=1e-3 * THR)
    R, _, _ = tess.recover_pose(res_t.E, _t(p), _t(p_t), mask=res_t.inliers)
    np.testing.assert_allclose(R.numpy(), T[:3, :3], atol=2e-2)
    # The samples' shape follows the solver.
    with pytest.raises(ValueError, match="samples must be"):
        transac.ransac_essential(None, _t(p), _t(p_t), n_hyp=N_HYP, solver="8pt",
                                 samples=samples)


def _outlier_scene(seed: int, outlier_ratio: float, N: int = 128):
    """The scene of tests/test_fivepoint.py's high-outlier test, drawn with
    the port's synthetic module: a random pose, N points with 5e-4 noise,
    the first outlier_ratio * N targets replaced by random directions."""
    g = torch.Generator().manual_seed(300 + seed)
    T = tsynth.random_pose(g)
    _, p, p_t = tsynth.gen_points(g, N, T, pixel_noise=5e-4)
    n_out = int(outlier_ratio * N)
    noise = -0.8 + 1.6 * torch.rand((n_out, 2), generator=g)
    p_t = torch.cat([torch.cat([noise, p_t[:n_out, 2:]], -1), p_t[n_out:]])
    return T, p, p_t


@pytest.mark.parametrize("outlier_ratio", [0.6, 0.7])
def test_five_point_ransac_beats_eight_point_high_outliers(outlier_ratio):
    """Twin of tests/test_fivepoint.py: at 60-70 % outliers with the same
    sample budget, the 5-point minimal sample finds the model where the
    8-point one usually cannot (0.4^8 ~ 6.5e-4 vs 0.4^5 = 1 %)."""
    wins_5 = wins_8 = 0
    for seed in range(5):
        T, p, p_t = _outlier_scene(seed, outlier_ratio)
        R_gt = T[:3, :3].numpy().astype(np.float64)

        def rot_err(res):
            R, _, _ = tess.recover_pose(res.E, p, p_t, mask=res.inliers)
            c = (np.trace(R.numpy().astype(np.float64).T @ R_gt) - 1) / 2
            return float(np.arccos(np.clip(c, -1, 1)))

        g = torch.Generator().manual_seed(seed)
        res5 = transac.ransac_essential(g, p, p_t, n_hyp=384, threshold=4e-5, solver="5pt")
        res8 = transac.ransac_essential(g, p, p_t, n_hyp=384, threshold=4e-5, solver="8pt")
        wins_5 += rot_err(res5) < np.deg2rad(2.0)
        wins_8 += rot_err(res8) < np.deg2rad(2.0)
    assert wins_5 >= 4, (wins_5, wins_8)
    assert wins_5 >= wins_8, (wins_5, wins_8)


def _config_5pt():
    from epivo_tpu_torch.geometry.camera import Pinhole

    return tconfig.VOConfig(
        camera=Pinhole(fx=110.0, fy=110.0, cx=WS / 2, cy=HS / 2, width=WS, height=HS),
        frontend=tconfig.FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                        klt_levels=3),
        ransac=tconfig.RansacConfig(n_hyp=128, solver="5pt"),
        lm=tconfig.LMConfig(n_points=16),
    )


def _rendered_pairs():
    """Frames 0 -> 1 of two small corridors (tests/test_torch_vo_batched.py)
    and their ground-truth relative poses (source -> target)."""
    K = np.array([[110.0, 0, WS / 2], [0, 110.0, HS / 2], [0, 0, 1.0]])
    src, tgt, T_gt = [], [], []
    for seed in (11, 12):
        frames, gt, _ = jphotoreal.corridor_sequence(2, H=HS, W=WS, K=K, speed=0.45,
                                                     seed=seed)
        frames = list(frames)
        src.append(np.asarray(frames[0], np.float32))
        tgt.append(np.asarray(frames[1], np.float32))
        T_gt.append(np.linalg.inv(gt[1]) @ gt[0])
    return np.stack(src), np.stack(tgt), T_gt


def test_vo_step_5pt_against_ground_truth_and_batched():
    src, tgt, T_gt = _rendered_pairs()
    cfg = _config_5pt()
    res = tvo.vo_step_batched(torch.from_numpy(src), torch.from_numpy(tgt),
                              torch.Generator().manual_seed(7), cfg)
    for lane in range(2):
        T = res.T[lane].numpy().astype(np.float64)
        assert not bool(res.reverted[lane])
        # 128 keypoints at 96x128 pin the direction loosely: over RANSAC
        # seeds 0-3 the 8-point step gives |dR|_F 0.0024-0.0088 and
        # direction errors 0.023-0.139 on these two pairs, the 5-point step
        # 0.0024-0.0074 and 0.023-0.176.
        assert np.linalg.norm(T[:3, :3] - T_gt[lane][:3, :3]) < 1e-2
        assert np.linalg.norm(_dir(T[:3, 3]) - _dir(T_gt[lane][:3, 3])) < 0.2
    # B = 2 against single steps on the same 5-point samples.
    samples = torch.stack([transac._sample_indices(
        torch.Generator().manual_seed(lane), 128, 128, None, 5) for lane in range(2)])
    res_b = tvo.vo_step_batched(torch.from_numpy(src), torch.from_numpy(tgt), None, cfg,
                                ransac_samples=samples)
    for lane in range(2):
        one = tvo.vo_step(torch.from_numpy(src[lane]), torch.from_numpy(tgt[lane]), None,
                          cfg, ransac_samples=samples[lane])
        _assert_step_close(res_b, one, lane, None)
    # The derived hypothesis count uses the 5-point sample size, as the
    # reference's does.
    for solver in ("5pt", "8pt"):
        ours = dataclasses.replace(cfg.ransac, n_hyp=None, solver=solver)
        assert ours.hypotheses() == jconfig.RansacConfig(solver=solver).hypotheses()
