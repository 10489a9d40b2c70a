"""Port parity: the ORB retry of ``_extract_pairs`` where it replaces the
KLT association.

The turn pair of ``tests/test_runners_datasets.py``'s slow fallback test
(``loop_trajectory`` frames 80 -> 81, a rotation-dominant turn past close
structure) at half its size, 94x620 with the focal length halved, FAST
threshold 12, 128 keypoints, 3 KLT levels, 256 hypotheses, 32 LM points
and the default ``orb_fallback_frac`` 0.25. Translation-only KLT keeps
about 21 RANSAC inliers there, under the retry floor of 32; ORB keeps
about 69 and replaces it.

Both packages run ``_extract_pairs`` on the pairs (0, 1) and (1, 0) with
the reference's RANSAC samples injected into the port in both passes
(``tests/test_torch_runners.py::extract_both``): the same pairs retried and
the same number replaced, and each pair within the tolerances of
``tests/test_torch_runners.py`` (source points equal, target points and
inlier masks equal on at least 97 % of the lanes, n_inliers within 3,
rotation and translation direction within 2e-3). The replaced pair's
rotation angle is within 0.2x of the ground truth's, with at least twice
the KLT-only inliers, as the slow test asks of the reference.
"""

import dataclasses

import numpy as np
import pytest

from epivo_tpu.geometry import camera as jcam
from epivo_tpu.pipeline.config import FrontendConfig, LMConfig, RansacConfig, VOConfig
from epivo_tpu_torch.datasets import photoreal
from tests.test_torch_runners import assert_pair_close, extract_both

H, W, F = 94, 620, 718.856 / 2
PAIRS = [(0, 1), (1, 0)]
K0 = 80  # mid-turn


def _angle(R):
    return np.degrees(np.arccos(np.clip((np.trace(np.asarray(R)[:3, :3]) - 1) / 2, -1, 1)))


@pytest.fixture(scope="module")
def turn(tmp_path_factory):
    K = np.array([[F, 0, W / 2.0], [0, F, H / 2.0], [0, 0, 1.0]])
    gt = photoreal.loop_trajectory()
    scene = photoreal.CorridorScene()
    tex = scene.textures()
    rng = np.random.default_rng(7)
    frames = [np.asarray(photoreal.render_frame(scene, tex, K, gt[k], H, W, noise_sigma=2.0,
                                                rng=rng), np.float32)
              for k in (K0, K0 + 1)]
    cfg = VOConfig(camera=jcam.Pinhole(F, F, W / 2.0, H / 2.0, W, H),
                   frontend=FrontendConfig(fast_threshold=12.0, max_keypoints=128,
                                           klt_levels=3),
                   ransac=RansacConfig(n_hyp=256), lm=LMConfig(n_points=32))
    out = extract_both(frames, PAIRS, cfg, 2, tmp_path_factory.mktemp("turn"))
    return (*out, _angle(np.linalg.inv(gt[K0 + 1]) @ gt[K0]), cfg, frames)


def test_retry_replaces_the_klt_association(turn):
    pd_j, ref_stats, pd_t, stats, retried, a_gt, cfg, frames = turn
    assert (0, 1) in retried
    assert stats["n_retried"] == ref_stats["n_retried"] == len(retried)
    assert stats["n_replaced"] == ref_stats["n_replaced"] >= 1
    from epivo_tpu_torch import convert
    from epivo_tpu_torch.pipeline import runners, stream

    off = dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend,
                                                                orb_fallback_frac=0.0))
    klt_only = runners._extract_pairs(stream.FrameStream(list(frames)), [(0, 1)],
                                      convert.config_from_reference(off), 0, n_points=32,
                                      batch=2, device="cpu")
    for pd in (pd_t, pd_j):
        assert abs(_angle(pd[(0, 1)]["T"]) - a_gt) < 0.2 * a_gt
        assert pd[(0, 1)]["n_inl"] > 2 * klt_only[(0, 1)]["n_inl"]


@pytest.mark.parametrize("pair", PAIRS)
def test_turn_pairs_match_reference(turn, pair):
    pd_j, _, pd_t, *_ = turn
    assert_pair_close(pd_t[pair], pd_j[pair])
