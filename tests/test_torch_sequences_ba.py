"""Port parity: ``run_ba_sequence`` against the reference's, end to end.

Each package runs the sequence with its own RANSAC draws (the reference's
``jax.random`` keys, the port's ``torch.Generator``), so the two are two
realizations of the same estimator. Each must meet the bounds of the
reference's own tests (``tests/test_runners_datasets.py``), and the two
trajectories must agree:

- with GT on the 7-frame fixture: ATE below 0.15; positions within 0.05 of
  the reference's; every extracted pair returned, forward pairs within 0.1
  of the GT direction and none flipped;
- without GT on the 7-frame fixture whose step lengths vary 2.5x
  (``make_varying_sequence``, with that test's scale settings): per-step
  length ratios within rtol 0.3 and cumulative ones within 0.6 of the
  truth, and each step length within 10 % of the reference's;
- with ORB association for every pair: the reference test's ATE bound.

One test takes the draws out: both packages' windowed BA on the same
pairs (the reference's), which must give the same windows and nearly the
same trajectory.
"""

import numpy as np
import pytest
import torch

from epivo_tpu.pipeline import runners as jrunners
from epivo_tpu.pipeline.config import BAConfig, LMConfig, ScaleConfig
from epivo_tpu_torch import convert
from epivo_tpu_torch.pipeline import runners as trunners
from epivo_tpu_torch.tools import photoreal_ate
from tests.test_runners_datasets import CAM, VO_CFG, make_sequence, make_varying_sequence
from tests.test_torch_sequences import _step_norms

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)


def _ba_config(**kw):
    return BAConfig(camera=CAM, frontend=VO_CFG.frontend, ransac=VO_CFG.ransac,
                    lm=LMConfig(n_points=32, revert_r_norm=1e-2), **kw)


def test_run_ba_sequence_matches_reference():
    frames, gt = make_sequence(F=7)
    cfg = _ba_config()
    res_j = jrunners.run_ba_sequence(frames, cfg, gt_poses=gt)
    res = trunners.run_ba_sequence(frames, convert.config_from_reference(cfg), gt_poses=gt,
                                   device="cpu")
    assert res.trajectory.shape == res_j.trajectory.shape and res.trajectory.shape[0] >= 6
    assert res.ate is not None and res.ate < 0.15, res.ate
    np.testing.assert_allclose(res.trajectory[:, :3, 3], res_j.trajectory[:, :3, 3], atol=0.05)
    st = res.stats
    assert st["n_windows"] == res.per_frame["window_r_norm"].shape[0] == 3
    assert st["n_pairs"] > 0 and st["n_retried"] >= st["n_replaced"] >= 0
    acc = photoreal_ate.pair_accuracy(res.pair_data, gt)
    assert acc["all"]["n"] == len(res.pair_data) == st["n_pairs"]
    assert acc["forward"]["flipped"] == 0 and acc["forward"]["dir_median"] < 0.1


def test_run_ba_sequence_no_gt_matches_reference():
    frames, _, mags = make_varying_sequence(F=7)
    cfg = _ba_config(scale=ScaleConfig(chain_hampel_ratio=0.0, graph_prior_sigma=0.5,
                                       graph_cut=2.0))
    res_j = jrunners.run_ba_sequence(frames, cfg, gt_poses=None)
    res = trunners.run_ba_sequence(frames, convert.config_from_reference(cfg), gt_poses=None,
                                   device="cpu")
    assert res.ate is None and res.stats["n_measurements"] > 0
    steps, steps_j = _step_norms(res.trajectory), _step_norms(res_j.trajectory)
    n = min(len(mags), steps.shape[0])
    np.testing.assert_allclose(steps[1:n] / steps[: n - 1], mags[1:n] / mags[: n - 1], rtol=0.3)
    np.testing.assert_allclose(steps[:n] / steps[0], mags[:n] / mags[0], rtol=0.6)
    np.testing.assert_allclose(steps, steps_j, rtol=0.1)


@pytest.mark.parametrize("with_gt", [True, False], ids=["gt", "no_gt"])
def test_back_half_on_the_same_pairs_matches_reference(with_gt, monkeypatch):
    """Both packages' ``run_ba_sequence`` on the reference's extracted
    pairs (extraction replaced, so no RANSAC draw differs): the window
    tensors equal, with the no-GT scale graph's ``c_scale`` and the scaled
    initial poses within 1e-5; the trajectories' rotations within 1e-3
    and positions within 1e-3 (GT) / 1e-2 (no GT, positions up to ~7),
    because the float32 LM may accept or reject a different step near
    the optimum (measured 7.5e-5 / 4.5e-3 in position)."""
    if with_gt:
        frames, gt = make_sequence(F=7)
        cfg = _ba_config()
    else:
        (frames, _, _), gt = make_varying_sequence(F=7), None
        cfg = _ba_config(scale=ScaleConfig(chain_hampel_ratio=0.0, graph_prior_sigma=0.5,
                                           graph_cut=2.0))
    tcfg = convert.config_from_reference(cfg)
    pairs = jrunners.prepare_mono_windows(frames, cfg, gt_poses=gt).pair_data
    same = lambda *a, **k: {p: dict(d) for p, d in pairs.items()}
    monkeypatch.setattr(jrunners, "_extract_pairs", same)
    monkeypatch.setattr(trunners, "_extract_pairs", same)

    wj = jrunners.prepare_mono_windows(frames, cfg, gt_poses=gt)
    wt = trunners.prepare_mono_windows(frames, tcfg, gt_poses=gt, device="cpu")
    np.testing.assert_allclose(wt.c_scale, np.asarray(wj.c_scale), rtol=1e-5)
    np.testing.assert_allclose(wt.T0s, np.asarray(wj.T0s), atol=1e-5)
    for q in ("p", "p_t", "pmask", "wreps"):
        np.testing.assert_array_equal(getattr(wt, q), np.asarray(getattr(wj, q)))

    res_j = jrunners.run_ba_sequence(frames, cfg, gt_poses=gt)
    res = trunners.run_ba_sequence(frames, tcfg, gt_poses=gt, device="cpu")
    Tj, T = np.asarray(res_j.trajectory), res.trajectory
    np.testing.assert_allclose(T[:, :3, :3], Tj[:, :3, :3], atol=1e-3)
    np.testing.assert_allclose(T[:, :3, 3], Tj[:, :3, 3], atol=1e-3 if with_gt else 1e-2)


def test_run_ba_sequence_orb():
    """ORB association for every pair (``use_orb``), the reference test's
    bound: ATE below 0.3 on the 5-frame fixture."""
    frames, gt = make_sequence(F=5)
    res = trunners.run_ba_sequence(frames, convert.config_from_reference(_ba_config()),
                                   gt_poses=gt, use_orb=True, device="cpu")
    assert res.trajectory.shape[0] >= 4
    assert res.ate is not None and res.ate < 0.3, res.ate
