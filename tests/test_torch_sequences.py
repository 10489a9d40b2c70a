"""Port parity: ``run_vo_sequence`` against the reference's, end to end,
and the corridor renderer of ``tools/photoreal_ate.py``.

Each package runs the sequence with its own RANSAC draws (the reference's
``jax.random`` keys, the port's ``torch.Generator``), so the two are two
realizations of the same estimator. Each must meet the bounds of the
reference's own tests (``tests/test_runners_datasets.py``), and the two
trajectories must agree:

- with GT scale on the 6-frame rendered fixture: ATE below 0.1, more than
  50 cloud points, 5 cloud limits, at least 21 inliers per step; frame
  positions within 0.05 of the reference's (the steps are 0.35 long);
- without GT: unit steps (rtol 1e-4).

The BA runner is ``tests/test_torch_sequences_ba.py``.
"""

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


def _step_norms(traj):
    return np.array([np.linalg.norm((np.linalg.inv(traj[i]) @ traj[i + 1])[:3, 3])
                     for i in range(traj.shape[0] - 1)])


def test_run_vo_sequence_matches_reference():
    frames, gt = make_sequence(F=6)
    res_j = jrunners.run_vo_sequence(frames, VO_CFG, gt_poses=gt, batch=3)
    res = trunners.run_vo_sequence(frames, convert.config_from_reference(VO_CFG),
                                   gt_poses=gt, batch=3, device="cpu")
    assert res.trajectory.shape == (6, 4, 4)
    assert res.ate is not None and res.ate < 0.1, res.ate
    assert res.cloud.shape[0] > 50 and len(res.cloud_limits) == 5
    assert res.per_frame["n_inliers"].min() > 20
    np.testing.assert_allclose(res.trajectory[:, :3, 3], res_j.trajectory[:, :3, 3], atol=0.05)
    np.testing.assert_allclose(res.gt_trajectory, res_j.gt_trajectory, atol=1e-12)


def test_run_vo_sequence_no_gt_unit_steps():
    frames, _ = make_sequence(F=4)
    res = trunners.run_vo_sequence(frames, convert.config_from_reference(VO_CFG),
                                   batch=4, device="cpu")
    assert res.ate is None
    np.testing.assert_allclose(_step_norms(res.trajectory), 1.0, rtol=1e-4)


def test_render_corridor_matches_the_sequence():
    """The corridor renderer of ``tools/photoreal_ate.py`` (two worker
    processes) gives the frames of ``corridor_sequence`` bit for bit."""
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.tools import photoreal_ate

    frames, gt, K, length = photoreal_ate.render_corridor(5, h=40, w=120, workers=2)
    ref, gt_ref, _ = photoreal.corridor_sequence(5, H=40, W=120, K=K, **photoreal_ate.FIXTURE)
    np.testing.assert_array_equal(gt, gt_ref)
    for a, b in zip(frames, ref, strict=True):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert length == pytest.approx(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1).sum())
