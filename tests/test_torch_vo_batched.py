"""Port parity: the batched two-view step (``vo_step_batched``, B pairs per
call) and the batched modules under it.

``vo_step_batched`` runs B = 2 small 96x128 corridor pairs (frames 0->1
of the corridor of ``tests/test_torch_vo.py``, seed 11, and of the same
corridor with seed 12) against ``jax.vmap`` of
the reference's ``vo_step``, with each lane's reference RANSAC samples
injected. Tolerances, lane by lane, as ``tests/test_torch_vo.py``:
n_tracked equal, n_inliers within 2, ||R_torch - R_jax||_F and the
translation direction within 1e-3, source keypoints equal, tracked
positions within 1e-3 px. A batched lane against the port's single
``vo_step`` with the same samples: the same tolerances (the batched and
single paths run the same operations on other shapes).

Batched ``ransac_essential`` (LMedS, B = 3 lanes with their own masks)
against ``jax.vmap`` of the reference, with the reference's samples: as
``tests/test_torch_essential_ransac_lm.py``, per lane (inlier sets 99 %
equal, counts within 1, E within 1e-4 up to sign). Batched
``refine_essential``: E within 1e-4 of the reference's ``jax.vmap``, up
to sign. The B = 1 Gumbel draw equals the unbatched draw exactly, and the
batched FAST detection equals per-frame detection exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu import ransac as jransac
from epivo_tpu.datasets import photoreal as jphotoreal
from epivo_tpu.frontend import fast as jfast, klt as jklt
from epivo_tpu.geometry import essential as jess, se3 as jse3
from epivo_tpu.geometry.camera import Pinhole as JPinhole
from epivo_tpu.pipeline import config as jconfig, vo as jvo
from epivo_tpu_torch import convert, ransac as transac
from epivo_tpu_torch.frontend import fast as tfast
from epivo_tpu_torch.geometry import essential as tess
from epivo_tpu_torch.pipeline import vo as tvo

HS, WS = 96, 128
B = 2


def _small_config():
    return jconfig.VOConfig(
        camera=JPinhole(fx=110.0, fy=110.0, cx=WS / 2, cy=HS / 2, width=WS, height=HS),
        frontend=jconfig.FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                        klt_levels=3),
        ransac=jconfig.RansacConfig(n_hyp=128),
        lm=jconfig.LMConfig(n_points=16),
    )


def _pairs():
    """[B, H, W] source and target frames: frames 0->1 of two corridors.

    (Frames 1->2 of seed 11 are ill-conditioned: there the reference's
    own ``vo_step`` and its ``jax.vmap`` part by more than the rotation
    tolerance.)
    """
    K = np.array([[110.0, 0, WS / 2], [0, 110.0, HS / 2], [0, 0, 1.0]])
    pairs = [[np.asarray(f, np.float32) for f in jphotoreal.corridor_sequence(
        2, H=HS, W=WS, K=K, speed=0.45, seed=seed)[0]] for seed in (11, 12)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _reference_samples(a, b, keys, cfg):
    """Each lane's sample indices, as the reference's vo_step draws them:
    its RANSAC mask is the KLT status of the same detect + track."""
    fc, rc = cfg.frontend, cfg.ransac

    def one(x, y, k):
        kp = jfast.detect(x, fc.fast_threshold, fc.max_keypoints)
        flow = jklt.track(x, y, kp.xy, valid=kp.valid, win=fc.klt_window,
                          levels=fc.klt_levels, iters=fc.klt_iters,
                          min_eig=fc.klt_min_eig)
        return jransac._sample_indices(k, rc.hypotheses(), fc.max_keypoints,
                                       flow.status)

    return np.asarray(jax.jit(jax.vmap(one))(a, b, keys))


def _dir(t):
    return t / np.linalg.norm(t)


def _assert_step_close(res_t, res_j, lane_t, lane_j):
    """Lane ``lane_t`` of the port's result against lane ``lane_j`` of the
    other (None: an unbatched result)."""
    pick = lambda x, b: np.asarray(x) if b is None else np.asarray(x)[b]
    assert int(pick(res_t.n_tracked, lane_t)) == int(pick(res_j.n_tracked, lane_j))
    assert abs(int(pick(res_t.n_inliers, lane_t)) - int(pick(res_j.n_inliers, lane_j))) <= 2
    T_t, T_j = pick(res_t.T, lane_t), pick(res_j.T, lane_j)
    assert np.linalg.norm(T_t[:3, :3] - T_j[:3, :3]) < 1e-3
    assert np.linalg.norm(_dir(T_t[:3, 3]) - _dir(T_j[:3, 3])) < 1e-3
    np.testing.assert_array_equal(pick(res_t.matches_src, lane_t),
                                  pick(res_j.matches_src, lane_j))
    np.testing.assert_allclose(pick(res_t.matches_tgt, lane_t),
                               pick(res_j.matches_tgt, lane_j), atol=1e-3)
    assert bool(pick(res_t.reverted, lane_t)) == bool(pick(res_j.reverted, lane_j))


@pytest.fixture(scope="module")
def batched_run():
    src, tgt = _pairs()
    cfg = _small_config()
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    a, b = jnp.asarray(src), jnp.asarray(tgt)
    res_j = jax.vmap(lambda x, y, k: jvo.vo_step(x, y, k, cfg))(a, b, keys)
    idx = convert.ransac_samples_from_reference(_reference_samples(a, b, keys, cfg))
    tcfg = convert.config_from_reference(cfg)
    res_t = tvo.vo_step_batched(torch.from_numpy(src), torch.from_numpy(tgt), None,
                                tcfg, ransac_samples=idx)
    return src, tgt, tcfg, idx, res_t, res_j


def test_vo_step_batched_matches_reference(batched_run):
    *_, res_t, res_j = batched_run
    assert res_t.T.shape == (B, 4, 4) and res_t.points.shape == (B, 128, 3)
    assert res_t.n_tracked.shape == res_t.reverted.shape == (B,)
    for lane in range(B):
        _assert_step_close(res_t, res_j, lane, lane)


def test_batched_lane_matches_single_step(batched_run):
    src, tgt, tcfg, idx, res_t, _ = batched_run
    for lane in range(B):
        one = tvo.vo_step(torch.from_numpy(src[lane]), torch.from_numpy(tgt[lane]),
                          None, tcfg, ransac_samples=idx[lane])
        assert one.T.shape == (4, 4) and one.n_tracked.shape == ()
        _assert_step_close(res_t, one, lane, None)


def test_batched_detect_and_draw_match_unbatched():
    src, _ = _pairs()
    imgs = torch.from_numpy(src)
    kp = tfast.detect(imgs, 12.0, 128)
    assert kp.xy.shape == (B, 128, 2)
    for lane in range(B):
        for a, b in zip(kp, tfast.detect(imgs[lane], 12.0, 128)):
            assert torch.equal(a[lane], b)
    mask = torch.arange(40) % 3 > 0
    one = transac._sample_indices(torch.Generator().manual_seed(4), 16, 40, mask)
    lead = transac._sample_indices(torch.Generator().manual_seed(4), 16, 40,
                                   mask[None], lead=(1,))
    assert torch.equal(lead[0], one)


def _scenes(n_lanes, N=96):
    """Per lane: matched normalized points of a forward-moving pose, with
    pixel-like noise and 20 % gross outliers, and its own validity mask."""
    rng = np.random.default_rng(12)
    ps, pts, masks = [], [], []
    for lane in range(n_lanes):
        xi = np.array([0.05, -0.02, 0.6, 0.02, -0.03, 0.015], np.float32) * (1 + 0.3 * lane)
        T = np.asarray(jse3.se3_exp(jnp.asarray(xi)), np.float64)
        X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                      rng.uniform(5, 20, N)], -1)
        Xt = X @ T[:3, :3].T + T[:3, 3]
        p_t = Xt / Xt[:, 2:3]
        p_t[:, :2] += rng.normal(0, 5e-4, (N, 2))
        bad = rng.uniform(size=N) < 0.2
        p_t[bad, :2] += rng.uniform(-0.2, 0.2, (bad.sum(), 2))
        ps.append(X / X[:, 2:3])
        pts.append(p_t)
        masks.append(rng.uniform(size=N) > 0.05 + 0.1 * lane)
    return (np.stack(ps).astype(np.float32), np.stack(pts).astype(np.float32),
            np.stack(masks))


def _up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = 1.0 if np.abs(a - b).max() <= np.abs(a + b).max() else -1.0
    np.testing.assert_allclose(a, s * b, atol=atol)


def test_ransac_lmeds_batched_matches_reference():
    p, p_t, mask = _scenes(3)
    n_lanes, N = mask.shape
    n_hyp, thr = 128, (1.0 / 300.0) ** 2
    keys = jax.random.split(jax.random.PRNGKey(3), n_lanes)
    res_j = jax.jit(jax.vmap(lambda k, a, b, m: jransac.ransac_essential(
        k, a, b, n_hyp=n_hyp, threshold=thr, mask=m, method="lmeds")))(
        keys, jnp.asarray(p), jnp.asarray(p_t), jnp.asarray(mask))
    idx = np.asarray(jax.vmap(lambda k, m: jransac._sample_indices(k, n_hyp, N, m))(
        keys, jnp.asarray(mask)))
    res_t = transac.ransac_essential(
        None, torch.from_numpy(p), torch.from_numpy(p_t), n_hyp=n_hyp, threshold=thr,
        mask=torch.from_numpy(mask), method="lmeds",
        samples=convert.ransac_samples_from_reference(idx))
    assert res_t.E.shape == (n_lanes, 3, 3) and res_t.inliers.shape == (n_lanes, N)
    for lane in range(n_lanes):
        inl_t, inl_j = res_t.inliers[lane].numpy(), np.asarray(res_j.inliers[lane])
        assert np.mean(inl_t == inl_j) >= 0.99
        assert abs(int(res_t.n_inliers[lane]) - int(res_j.n_inliers[lane])) <= 1
        _up_to_sign(res_t.E[lane].numpy(), res_j.E[lane], 1e-4)
        np.testing.assert_allclose(float(res_t.best_score[lane]),
                                   float(res_j.best_score[lane]),
                                   rtol=1e-3, atol=1e-3 * thr)


def test_refine_essential_batched_matches_reference():
    p, p_t, mask = _scenes(3)
    E0 = jax.vmap(jess.eight_point)(jnp.asarray(p), jnp.asarray(p_t))
    E_j = jax.jit(jax.vmap(jess.refine_essential))(E0, jnp.asarray(p), jnp.asarray(p_t),
                                                   jnp.asarray(mask))
    E_t = tess.refine_essential(torch.from_numpy(np.array(E0)), torch.from_numpy(p),
                                torch.from_numpy(p_t), mask=torch.from_numpy(mask))
    assert E_t.shape == (3, 3, 3) and E_t.dtype == torch.float32
    for lane in range(3):
        _up_to_sign(E_t[lane].numpy(), E_j[lane], 1e-4)
