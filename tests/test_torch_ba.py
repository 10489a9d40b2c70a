"""Port parity: windowed BA (``pipeline/ba.py``) against the JAX package.

``ba_windows`` runs on the first 8 windows of ``bench_ba_workload.npz``
(the bench's BA workload: ws = 3 windows extracted from the corridor
sequence, 32 points per constraint) with the bench's BA config, in both
packages; the reference runs both of its solvers (``use_lanes=True``, the
lane-major LM, and ``False``, the vmapped LM). Tolerances, against each
reference route:

- ``T_opt``: rotations within 1e-4 and translation directions within 3e-3
  (the twin test ``tests/test_lm_lanes.py`` holds poses to 3e-3). The
  translation magnitudes are not compared: the epipolar energy does not
  see the global scale and barely sees the ratio of a window's two
  translations, so LM's drift along them is rounding: the reference's
  own two routes already differ in them on these windows by far more
  than the pose tolerance.
- ``r_norm`` rtol 0.2 and atol 1e-5, ``n_accepted`` within 8 (the twin
  test's bounds); ``reverted`` equal.

The window specs are compared exactly; the host helpers (stitching,
trajectories, scale propagation, the boundary scale ratio) to 1e-5
(float32 products in another order).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.geometry import se3 as jse3
from epivo_tpu.pipeline import ba as jba, config as jconfig
from epivo_tpu_torch import convert
from epivo_tpu_torch.pipeline import ba as tba, config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_WINDOWS = 8


def _workload():
    z = np.load(os.path.join(REPO, "bench_ba_workload.npz"))
    return {k: z[k][:N_WINDOWS] for k in ("T0s", "p", "p_t", "wreps", "pmask")}, z["reps"]


def _bench_ba_config():
    """The BA config of ``bench.py``'s BA workload (ws 3, 32 points, 30
    iterations, revert above 1e-2)."""
    return jconfig.BAConfig(
        lm=jconfig.LMConfig(n_points=32, max_iters=30, revert_r_norm=1e-2),
        window_size=3, stride=2)


def _rot_dir(T):
    T = np.asarray(T, np.float64)
    t = T[..., :3, 3]
    return T[..., :3, :3], t / np.linalg.norm(t, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def port_result():
    d, _ = _workload()
    cfg = convert.config_from_reference(_bench_ba_config())
    args = [torch.from_numpy(d[k]) for k in ("T0s", "p", "p_t", "wreps", "pmask")]
    outs = [tba.ba_windows(args[0], tba.mono_window_spec(3), args[1], args[2],
                           wreps=args[3], pmask=args[4], config=cfg, use_lanes=lanes)
            for lanes in (True, False)]
    # use_lanes is accepted and ignored: one solver.
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    return outs[0]


@pytest.mark.parametrize("use_lanes", [True, False])
def test_ba_windows_matches_reference(port_result, use_lanes):
    d, reps = _workload()
    spec = jba.mono_window_spec(3)
    np.testing.assert_array_equal(spec.reps, reps)
    ref = jba.ba_windows(jnp.asarray(d["T0s"]), spec, jnp.asarray(d["p"]),
                         jnp.asarray(d["p_t"]), wreps=jnp.asarray(d["wreps"]),
                         pmask=jnp.asarray(d["pmask"]), config=_bench_ba_config(),
                         use_lanes=use_lanes)
    out = port_result
    assert out.T_opt.shape == (N_WINDOWS, 2, 4, 4)
    R_t, dir_t = _rot_dir(out.T_opt.numpy())
    R_j, dir_j = _rot_dir(ref.T_opt)
    np.testing.assert_allclose(R_t, R_j, atol=1e-4)
    np.testing.assert_allclose(dir_t, dir_j, atol=3e-3)
    np.testing.assert_allclose(out.r_norm.numpy(), np.asarray(ref.r_norm),
                               rtol=0.2, atol=1e-5)
    np.testing.assert_array_equal(out.reverted.numpy(), np.asarray(ref.reverted))
    d_acc = out.n_accepted.numpy().astype(int) - np.asarray(ref.n_accepted)
    assert np.abs(d_acc).max() <= 8, d_acc
    # The windows really moved, and none reverted on this workload.
    assert np.abs(out.T_opt.numpy() - d["T0s"]).max() > 1e-2
    assert not out.reverted.any()


def test_ba_reverts_above_threshold():
    d, _ = _workload()
    cfg = tconfig.BAConfig(lm=tconfig.LMConfig(n_points=32, max_iters=5,
                                               revert_r_norm=0.0))
    T0s = torch.from_numpy(d["T0s"][:2])
    out = tba.ba_windows(T0s, tba.mono_window_spec(3), torch.from_numpy(d["p"][:2]),
                         torch.from_numpy(d["p_t"][:2]), config=cfg)
    assert out.reverted.all() and torch.equal(out.T_opt, T0s)


@pytest.mark.parametrize("ws", [3, 4])
def test_window_specs_match_reference(ws):
    a, b = tba.mono_window_spec(ws), jba.mono_window_spec(ws)
    assert a.n_zeta == b.n_zeta and a.zeta_mask is None and b.zeta_mask is None
    np.testing.assert_array_equal(a.reps, b.reps)
    np.testing.assert_array_equal(a.frame_pairs, b.frame_pairs)
    for freeze in (True, False):
        (sa, wa), (sb, wb) = (tba.stereo_window_spec(ws, freeze),
                              jba.stereo_window_spec(ws, freeze))
        assert sa.n_zeta == sb.n_zeta
        for x, y in ((sa.reps, sb.reps), (sa.frame_pairs, sb.frame_pairs), (wa, wb),
                     (sa.zeta_mask, sb.zeta_mask)):
            np.testing.assert_array_equal(x, y)


def _random_poses(n, seed):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 0.2, (n, 6)).astype(np.float32)
    return np.array(jse3.se3_exp(jnp.asarray(xi)))


def test_chain_helpers_match_reference():
    T = _random_poses(12, 0)
    T_opt = T.reshape(6, 2, 4, 4)
    zetas_t = tba.stitch_windows(torch.from_numpy(T_opt))
    np.testing.assert_array_equal(zetas_t.numpy(),
                                  np.asarray(jba.stitch_windows(jnp.asarray(T_opt))))
    for f_t, f_j in ((tba.trajectory_from_zetas, jba.trajectory_from_zetas),
                     (tba.stereo_left_trajectory, jba.stereo_left_trajectory)):
        np.testing.assert_allclose(f_t(torch.from_numpy(T)).numpy(),
                                   np.asarray(f_j(jnp.asarray(T))), atol=1e-5)
    scales = np.linspace(0.5, 2.0, 12).astype(np.float32)
    np.testing.assert_allclose(
        tba.propagate_scale(torch.from_numpy(T), torch.from_numpy(scales)).numpy(),
        np.asarray(jba.propagate_scale(jnp.asarray(T), jnp.asarray(scales))), atol=1e-5)
    assert torch.equal(tba.propagate_scale(torch.from_numpy(T)), torch.from_numpy(T))


def _boundary_case(seed, n=40):
    """Landmarks seen from a boundary frame b, tracked back to b-1 and on
    to b+1; window w+1's translation is in other units (x 0.6), so the
    ratio that brings it into window w's units is 1 / 0.6."""
    rng = np.random.default_rng(seed)
    T_prev, T_next = _random_poses(2, seed + 1).astype(np.float64)
    T_prev[:3, 3] += [0.0, 0.0, -1.0]
    T_next[:3, 3] += [0.0, 0.0, -1.0]
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(6, 30, n)], -1)
    T_back = np.linalg.inv(T_prev)

    def proj(T, Y):
        Z = Y @ T[:3, :3].T + T[:3, 3]
        return (Z / Z[:, 2:3]).astype(np.float32)

    p = (X / X[:, 2:3]).astype(np.float32)
    T_next_units = T_next.copy()
    T_next_units[:3, 3] *= 0.6
    mask = rng.uniform(size=n) > 0.2
    return (T_prev.astype(np.float32), T_next_units.astype(np.float32), p,
            proj(T_back, X), mask, p, proj(T_next, X), mask)


@pytest.mark.parametrize("seed", [0, 1])
def test_boundary_scale_ratio_matches_reference(seed):
    args = _boundary_case(seed)
    s_t = tba.boundary_scale_ratio(*args)
    s_j = jba.boundary_scale_ratio(*args)
    assert isinstance(s_t, float)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-5)
    np.testing.assert_allclose(s_t, 1 / 0.6, rtol=1e-3)
    few = list(args)
    few[4] = few[7] = np.zeros_like(args[4])
    assert tba.boundary_scale_ratio(*few) == jba.boundary_scale_ratio(*few) == 1.0


def test_ba_config_from_reference():
    ref = _bench_ba_config()
    ref = dataclasses.replace(
        ref, scale=jconfig.ScaleConfig(graph_huber=3.0, chain_smooth=3),
        global_ba=jconfig.GlobalBAConfig(enabled=True, cg_iters=9),
        loop=jconfig.LoopConfig(min_gap=50, sim3=False))
    for src in (ref, dataclasses.asdict(ref)):
        out = convert.config_from_reference(src)
        assert isinstance(out, tconfig.BAConfig)
        assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert convert.config_from_reference(jconfig.BAConfig()) == tconfig.BAConfig()
    bad = dataclasses.asdict(ref)
    bad["scale"]["bogus"] = 1
    with pytest.raises(ValueError, match="bogus"):
        convert.config_from_reference(bad)
