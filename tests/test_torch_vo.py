"""Port parity: the two-view VO step as a whole, and the package boundary.

``vo_step`` runs on a small corridor pair (the small configuration of
``__graft_entry__.dryrun_multichip``) in both packages, with the
reference's RANSAC samples injected into the port. Tolerances: n_tracked
equal, n_inliers within 2, ||R_torch - R_jax||_F < 1e-3 and the
translation direction within 1e-3 (float32 through RANSAC, refine-E and
30 LM iterations, sums in another order).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu import ransac as jransac
from epivo_tpu.datasets import photoreal as jphotoreal
from epivo_tpu.frontend import fast as jfast, klt as jklt
from epivo_tpu.geometry.camera import Pinhole as JPinhole
from epivo_tpu.pipeline import config as jconfig, vo as jvo
from epivo_tpu_torch import convert
from epivo_tpu_torch.datasets import photoreal as tphotoreal
from epivo_tpu_torch.pipeline import config as tconfig, vo as tvo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HS, WS = 96, 128


def _small_config():
    return jconfig.VOConfig(
        camera=JPinhole(fx=110.0, fy=110.0, cx=WS / 2, cy=HS / 2, width=WS, height=HS),
        frontend=jconfig.FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                        klt_levels=3),
        ransac=jconfig.RansacConfig(n_hyp=128),
        lm=jconfig.LMConfig(n_points=16),
    )


def _small_pair():
    K = np.array([[110.0, 0, WS / 2], [0, 110.0, HS / 2], [0, 0, 1.0]])
    frames, gt, _ = jphotoreal.corridor_sequence(2, H=HS, W=WS, K=K, speed=0.45,
                                                 seed=11)
    return [np.asarray(f) for f in frames], gt


def _reference_samples(img0, img1, key, cfg):
    """The sample indices the reference's vo_step draws: its RANSAC mask is
    the KLT status of the same detect + track."""
    fc, rc = cfg.frontend, cfg.ransac

    @jax.jit
    def samples(a, b, k):
        kp = jfast.detect(a, fc.fast_threshold, fc.max_keypoints)
        flow = jklt.track(a, b, kp.xy, valid=kp.valid, win=fc.klt_window,
                          levels=fc.klt_levels, iters=fc.klt_iters,
                          min_eig=fc.klt_min_eig)
        return jransac._sample_indices(k, rc.hypotheses(), fc.max_keypoints,
                                       flow.status)

    return np.asarray(samples(img0, img1, key))


def _dir(t):
    return t / np.linalg.norm(t)


def test_vo_step_matches_reference():
    (f0, f1), gt = _small_pair()
    cfg = _small_config()
    key = jax.random.PRNGKey(7)
    a, b = jnp.asarray(f0), jnp.asarray(f1)
    res_j = jvo.vo_step(a, b, key, cfg)
    idx = _reference_samples(a, b, key, cfg)

    res_t = tvo.vo_step(torch.from_numpy(f0), torch.from_numpy(f1), None,
                        convert.config_from_reference(cfg),
                        ransac_samples=convert.ransac_samples_from_reference(idx))
    assert int(res_t.n_tracked) == int(res_j.n_tracked)
    assert abs(int(res_t.n_inliers) - int(res_j.n_inliers)) <= 2
    T_j, T_t = np.asarray(res_j.T), res_t.T.numpy()
    assert np.linalg.norm(T_t[:3, :3] - T_j[:3, :3]) < 1e-3
    assert np.linalg.norm(_dir(T_t[:3, 3]) - _dir(T_j[:3, 3])) < 1e-3
    np.testing.assert_array_equal(res_t.matches_src.numpy(), np.asarray(res_j.matches_src))
    np.testing.assert_allclose(res_t.matches_tgt.numpy(), np.asarray(res_j.matches_tgt),
                               atol=1e-3)
    assert bool(res_t.reverted) == bool(res_j.reverted)

    # Both land near the ground truth (source -> target relative pose).
    T_gt = np.linalg.inv(np.linalg.inv(gt[0]) @ gt[1])
    assert np.linalg.norm(T_t[:3, :3] - T_gt[:3, :3]) < 0.02

    # The port's own sampler (a torch.Generator) gives a pose just as good.
    res_g = tvo.vo_step(torch.from_numpy(f0), torch.from_numpy(f1),
                        torch.Generator().manual_seed(0),
                        convert.config_from_reference(cfg))
    assert np.linalg.norm(res_g.T.numpy()[:3, :3] - T_gt[:3, :3]) < 0.02


def test_vo_step_flat_frames_degenerate():
    """Textureless frames: no keypoints, yet a finite fallback pose."""
    cfg = convert.config_from_reference(_small_config())
    flat = torch.full((HS, WS), 90.0)
    res = tvo.vo_step(flat, flat, torch.Generator().manual_seed(0), cfg)
    assert int(res.n_tracked) == 0
    assert bool(torch.isfinite(res.T).all())
    assert bool(res.reverted)


def test_trajectory_helpers_match_reference():
    rng = np.random.default_rng(0)
    from epivo_tpu.geometry import se3 as jse3
    dTs = np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.1, (5, 6)).astype(np.float32))))
    np.testing.assert_allclose(
        tvo.accumulate_trajectory(torch.from_numpy(dTs)).numpy(),
        np.asarray(jvo.accumulate_trajectory(jnp.asarray(dTs))), atol=1e-5)
    s = np.float32(2.5)
    np.testing.assert_allclose(
        tvo.apply_scale(torch.from_numpy(dTs), torch.tensor(s)).numpy(),
        np.asarray(jvo.apply_scale(jnp.asarray(dTs), jnp.asarray(s))), atol=1e-6)
    mask = rng.uniform(size=40) > 0.5
    idx_t, v_t = tvo._select_top(torch.from_numpy(mask), 12)
    idx_j, v_j = jvo._select_top(jnp.asarray(mask), 12)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_config_from_reference_round_trip():
    ref = jconfig.VOConfig(
        camera=JPinhole(fx=500.0, fy=501.0, cx=320.5, cy=240.25, width=640, height=480),
        frontend=jconfig.FrontendConfig(fast_threshold=33.0, max_keypoints=300,
                                        klt_window=15, klt_levels=3, klt_iters=9,
                                        klt_min_eig=2e-4, orb_pyramid=True,
                                        orb_levels=5, orb_scale_factor=1.3,
                                        orb_fallback_frac=0.1, orb_fallback_max=7),
        ransac=jconfig.RansacConfig(n_hyp=None, confidence=0.95, outlier_ratio=0.4,
                                    threshold_px=0.7, method="lmeds", solver="8pt",
                                    refine_e=False, refine_iters=3),
        lm=jconfig.LMConfig(lambda0=0.1, epsilon=1e-7, max_iters=11, huber_delta=1e-4,
                            n_points=20, min_points=9, revert_r_norm=1e-3),
    )
    for src in (ref, dataclasses.asdict(ref)):
        out = convert.config_from_reference(src)
        assert isinstance(out, tconfig.VOConfig)
        got = dataclasses.asdict(out)
        # The port's own field (raw frames' lens): the reference's frames are pinhole.
        assert got.pop("distortion") is None
        assert got == dataclasses.asdict(ref)
    assert out.ransac.hypotheses() == ref.ransac.hypotheses()
    assert convert.config_from_reference(jconfig.VOConfig()) == tconfig.VOConfig()
    bad = dataclasses.asdict(ref)
    bad["lm"]["momentum"] = 0.9
    with pytest.raises(ValueError, match="momentum"):
        convert.config_from_reference(bad)
    with pytest.raises(ValueError):
        convert.ransac_samples_from_reference(np.zeros((4, 8), np.float32))


def test_photoreal_copy_is_bit_identical():
    frames_j, gt_j, K_j = jphotoreal.corridor_sequence(2, H=40, W=64, seed=3)
    frames_t, gt_t, K_t = tphotoreal.corridor_sequence(2, H=40, W=64, seed=3)
    np.testing.assert_array_equal(gt_t, gt_j)
    np.testing.assert_array_equal(K_t, K_j)
    for a, b in zip(frames_t, frames_j):
        np.testing.assert_array_equal(a, b)


def test_package_imports_without_jax():
    prog = (
        "import importlib, pkgutil, sys\n"
        "import epivo_tpu_torch\n"
        "for m in pkgutil.walk_packages(epivo_tpu_torch.__path__, 'epivo_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'epivo_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print(len([m for m in sys.modules if m.startswith('epivo_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", prog], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.strip()) >= 15
