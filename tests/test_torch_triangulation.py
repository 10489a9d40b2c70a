"""Port parity: ``run_gt_triangulation_sequence`` against the reference's.

- With its own RANSAC draws on the rendered 4-frame fixture of
  ``tests/test_runners_datasets.py``, the port meets the bounds of the
  reference's ``test_run_gt_triangulation_sequence``: more than 20 cloud
  points, the trajectory equal to the ground truth, the median distance of
  a cloud point to its nearest true landmark below 1.0 and more than 75 %
  of the points within 2.0.
- On the reference's extracted pairs (its ``_extract_pairs`` recorded and
  fed to both packages, so no draw differs): the same points kept per
  pair, the cloud within 1e-5 relative (float32 triangulation in another
  order of operations, then the same float64 world transform; points lie
  up to ~18 away, where float32 keeps ~1e-6 relative: measured 1.2e-6)
  and the limits and ``n_points`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.pipeline import runners as jrunners
from epivo_tpu_torch import convert
from epivo_tpu_torch.pipeline import runners as trunners
from tests.test_runners_datasets import VO_CFG, make_sequence

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)

TCFG = convert.config_from_reference(VO_CFG)


def _true_landmarks():
    """The fixture's landmarks (world frame = frame-0 camera frame)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    z = jax.random.uniform(k1, (140,), minval=6.0, maxval=18.0)
    xy = jax.random.uniform(k2, (140, 2), minval=-0.7, maxval=0.7) * z[:, None]
    return np.asarray(jnp.concatenate([xy, z[:, None]], axis=-1))


def test_run_gt_triangulation_sequence_own_draws():
    frames, gt = make_sequence(F=4)
    res = trunners.run_gt_triangulation_sequence(frames, TCFG, gt_poses=gt, device="cpu")
    assert res.cloud.shape[0] > 20
    np.testing.assert_allclose(res.trajectory, res.gt_trajectory)
    np.testing.assert_allclose(res.trajectory, np.linalg.inv(gt[0])[None] @ gt, atol=1e-12)
    d2 = np.linalg.norm(res.cloud[:, None, :] - _true_landmarks()[None], axis=-1).min(1)
    assert np.median(d2) < 1.0, np.median(d2)
    assert (d2 < 2.0).mean() > 0.75, (d2 < 2.0).mean()
    assert len(res.cloud_limits) == 3 and res.per_frame["n_points"].sum() == len(res.cloud)


def test_run_gt_triangulation_sequence_on_the_reference_pairs(monkeypatch):
    frames, gt = make_sequence(F=4)
    seen = []
    extract = jrunners._extract_pairs

    def record(*a, **kw):
        seen.append(extract(*a, **kw))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrunners, "_extract_pairs", record)
        res_j = jrunners.run_gt_triangulation_sequence(frames, VO_CFG, gt_poses=gt)
    monkeypatch.setattr(trunners, "_extract_pairs",
                        lambda *a, **k: {p: dict(d) for p, d in seen[0].items()})
    res = trunners.run_gt_triangulation_sequence(frames, TCFG, gt_poses=gt, device="cpu")
    np.testing.assert_array_equal(res.cloud_limits, res_j.cloud_limits)
    np.testing.assert_array_equal(res.per_frame["n_points"], res_j.per_frame["n_points"])
    assert res.cloud.shape == res_j.cloud.shape and res.cloud.shape[0] > 20
    np.testing.assert_allclose(res.cloud, np.asarray(res_j.cloud), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.trajectory, res_j.trajectory, atol=1e-12)
