"""Port parity: ``run_stereo_ba_sequence`` against the reference's.

End to end, each package runs with its own RANSAC draws (the reference's
``jax.random`` keys, the port's ``torch.Generator``), so the two are two
realizations of the same estimator, each held to the bounds of the
reference's own test (``tests/test_runners_datasets.py``) on the rendered
stereo fixture (``make_stereo_sequence(F=4)``): every metric step length
within rtol 0.25 of the ground truth, ATE below 0.2. (The EuRoC-style rig
and the pairs of known geometry are ``tests/test_torch_stereo_scale.py``.)

On the reference's extracted pairs (its ``_extract_pairs`` recorded, then
fed to both back halves, so no draw differs), within 1e-5: the per-step
ratio-median inits ``s0``, the refined scales ``s`` before and after the
second Hampel pass, the scale used per step, and every window's initial
poses ``T0s``; the Hampel flags, the refinement's convergence flags,
``n_used`` and the window weights ``wreps`` equal; the ``stereo_scale``
records field for field (the rounded fields within their last digit).
The final trajectory within 1e-4 (the steps are ~0.35): LM runs in
float32 in both frameworks and reorders its sums, and the float32 LM may
accept or reject a different step near the optimum (measured 1.2e-7 in
rotation and 4.9e-7 in position on the rendered fixture's pairs, where
the f64 refinement converges on no step; ``test_torch_stereo_scale.py``
covers the steps where it does).

``mesh`` still raises ``NotImplementedError``; ``config.loop.enabled``
passes (``tests/test_torch_loopclose.py`` runs it).
"""

import json

import numpy as np
import pytest
import torch

from epivo_tpu.pipeline import runners as jrunners, scale as jscale
from epivo_tpu.pipeline.config import BAConfig, LMConfig
from epivo_tpu_torch import convert
from epivo_tpu_torch.pipeline import runners as trunners
from tests.test_runners_datasets import CAM, VO_CFG, make_stereo_sequence

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)

CFG = BAConfig(camera=CAM, frontend=VO_CFG.frontend, ransac=VO_CFG.ransac,
               lm=LMConfig(n_points=32, revert_r_norm=1e-2))
TCFG = convert.config_from_reference(CFG)


def _steps(traj):
    return np.linalg.norm(np.diff(np.asarray(traj)[:, :3, 3], axis=0), axis=-1)


def _recording(monkeypatch, module, name, seen: list):
    """Replace ``module.name`` by a wrapper that appends (args, kwargs,
    result) of each call to ``seen``."""
    fn = getattr(module, name)

    def record(*args, **kw):
        out = fn(*args, **kw)
        seen.append((args, kw, out))
        return out

    monkeypatch.setattr(module, name, record)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's run on the stereo fixture, with its extracted
    pairs, its Hampel passes (inputs, outputs, flags), its window tensors
    and its metrics log recorded."""
    L, R, gt, T_rig = make_stereo_sequence(F=4)
    log = tmp_path_factory.mktemp("stereo") / "ref.jsonl"
    pairs, hampel, solve = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        _recording(mp, jrunners, "_extract_pairs", pairs)
        _recording(mp, jscale, "hampel_log", hampel)
        _recording(mp, jrunners, "_solve_windows", solve)
        res = jrunners.run_stereo_ba_sequence(L, R, CFG, T_rig=T_rig, gt_poses=gt,
                                              metrics_path=str(log))
    records = [json.loads(line) for line in log.read_text().splitlines()]
    return dict(frames=(L, R, gt, T_rig), res=res, pairs=pairs[0][2], hampel=hampel,
                solve=solve[0][0], records=records)


def _metric_bounds(res, rtol, ate):
    assert res.trajectory.shape[0] >= 3
    np.testing.assert_allclose(_steps(res.trajectory), _steps(res.gt_trajectory), rtol=rtol)
    assert res.ate is not None and res.ate < ate, res.ate


def test_run_stereo_ba_sequence_matches_reference(reference_run):
    """Both packages with their own draws, at the reference test's bounds;
    the port's stats count what it did."""
    L, R, gt, T_rig = reference_run["frames"]
    _metric_bounds(reference_run["res"], 0.25, 0.2)
    res = trunners.run_stereo_ba_sequence(L, R, TCFG, T_rig=T_rig, gt_poses=gt,
                                          device="cpu")
    _metric_bounds(res, 0.25, 0.2)
    assert res.trajectory.shape == reference_run["res"].trajectory.shape
    np.testing.assert_allclose(res.gt_trajectory, reference_run["res"].gt_trajectory,
                               atol=1e-12)
    st = res.stats
    # F = 4: one window, steps 0-1: rig (0,1), (2,3); temporal (0,2), (2,4);
    # cross (1,2), (3,4).
    assert sorted(res.pair_data) == sorted(reference_run["pairs"]) == [
        (0, 1), (0, 2), (1, 2), (2, 3), (2, 4), (3, 4)]
    assert st["n_pairs"] == 6 and st["n_windows"] == 1 and st["n_reverted"] == 0
    assert st["n_scale_steps"] == 2 and 0 < st["peak_buffered"] <= 8
    assert st["n_retried"] >= st["n_replaced"] >= 0


def _same_nan(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], rtol=0, atol=atol)


def test_back_half_on_the_reference_pairs(reference_run, monkeypatch, tmp_path):
    """The scale passes, window initialization and solve of both packages
    on the reference's pairs (tolerances in the module docstring)."""
    L, R, gt, T_rig = reference_run["frames"]
    pairs = reference_run["pairs"]
    same = lambda *a, **k: {p: dict(d) for p, d in pairs.items()}
    monkeypatch.setattr(trunners, "_extract_pairs", same)
    ss = trunners.stereo_step_scales(pairs, 4, T_rig, TCFG, device="cpu")
    (h0_in,), _, (h0_out, h0_rep) = reference_run["hampel"][0]
    (h1_in,), _, (h1_out, h1_rep) = reference_run["hampel"][1]
    _same_nan(ss.s0, h0_in, 1e-5)
    _same_nan(ss.s0_clean, h0_out, 1e-5)
    _same_nan(ss.s_refined, h1_in, 1e-5)
    fin = np.isfinite(np.asarray(h1_out, np.float64))
    np.testing.assert_allclose(ss.scale[fin], np.asarray(h1_out)[fin], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ss.replaced0, h0_rep)
    np.testing.assert_array_equal(ss.replaced1, h1_rep)
    assert np.isfinite(ss.s0).any() and ss.ks == [0, 1]

    solve = []
    _recording(monkeypatch, trunners, "_solve_windows", solve)
    log = tmp_path / "port.jsonl"
    res = trunners.run_stereo_ba_sequence(L, R, TCFG, T_rig=T_rig, gt_poses=gt,
                                          metrics_path=str(log), device="cpu")
    T0s, spec, p, p_t, wreps, pmask = solve[0][0][:6]
    ref = reference_run["solve"]
    np.testing.assert_allclose(T0s, np.asarray(ref[0]), rtol=0, atol=1e-5)
    for a, b in ((spec.reps, ref[1].reps), (p, ref[2]), (p_t, ref[3]), (wreps, ref[4]),
                 (pmask, ref[5])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    rec = lambda records: [r for r in records if r.get("stage") == "stereo_scale"]
    got = rec(json.loads(line) for line in log.read_text().splitlines())
    want = rec(reference_run["records"])
    assert len(got) == len(want) == 3
    steps = {r["step"]: r for r in want}
    for g in got:
        w = steps[g["step"]]
        for k in ("stage", "n_used", "refined", "hampel_replaced"):
            assert g[k] == w[k], (k, g, w)
        for k, atol in (("s0", 1e-5), ("s", 1e-5), ("gated_frac", 1e-3),
                        ("inlier_frac", 1e-3), ("rel_err", 1e-4)):
            assert (g[k] is None) == (w[k] is None), (k, g, w)
            if g[k] is not None:
                assert g[k] == pytest.approx(w[k], abs=atol), (k, g, w)
        assert g["s"] == pytest.approx(float(ss.scale[g["step"]]), abs=0)

    Tj, T = np.asarray(reference_run["res"].trajectory), res.trajectory
    np.testing.assert_allclose(T, Tj, atol=1e-4)


def test_stereo_refuses_what_is_not_ported():
    from epivo_tpu_torch.pipeline.config import BAConfig as TBAConfig, LoopConfig

    L = R = [np.zeros((8, 8), np.float32)] * 4
    with pytest.raises(NotImplementedError, match="A14"):
        trunners.run_stereo_ba_sequence(L, R, TCFG, T_rig=np.eye(4), mesh=object(),
                                        device="cpu")
    # Loop closure is ported: the refusal reads only the mesh, and the mesh
    # beside loop closure is still refused.
    trunners._refuse(None)
    with pytest.raises(NotImplementedError, match="A14"):
        trunners.run_stereo_ba_sequence(L, R, TBAConfig(loop=LoopConfig(enabled=True)),
                                        T_rig=np.eye(4), mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trunners.run_stereo_ba_sequence(L, R, TCFG, T_rig=np.eye(4))
