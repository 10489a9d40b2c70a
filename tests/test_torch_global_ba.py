"""Port parity: the global (full-trajectory) BA polish
(``parallel/global_ba.py``, ``runners.refine_global`` and its stage in
``run_ba_sequence``).

Inputs are the reference's ``chain_scene`` (``tests/test_global_ba.py``)
and an 11-frame rendered corridor. Tolerances:

- ``global_ba_solve`` against the reference on the same inputs: poses
  within 5e-3 (the reference's own 1-vs-8-device bound,
  ``tests/test_global_ba.py:80-82``: both runs reach the float32 residual
  floor by inexact CG steps), r_norm within 5 % or 1e-6;
- the banded prefix products against the dense ``se3.prefix_products``
  on the band: within 2e-6 (4x4 products in the same order, batched);
- a repeat is bit-equal (the fixed-order gather-sum);
- ``refine_global`` against the reference's on the same zetas and pairs:
  rotations within 5e-4 and translation directions within 1e-2 (the
  polish moves the directions by 0.006-0.045 here; the two LMs accept 6
  and 7 of 10 steps, so their inexact paths part; the reference holds its
  own sharded stage to its single-device one at 2e-2,
  ``tests/test_global_ba.py:167``), norms kept to 1e-5, r_norm within 5 %
  or 1e-6. The solver's own translation norms are a free gauge of the
  epipolar energy (they differ by 0.4 between the packages), which is why
  the stage keeps the input norms.

The twins of ``tests/test_global_ba.py:28-56,91-167`` (recovery, long
span, span guard, energy decrease, the runner stage without its mesh
part) run on the port alone.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.datasets import photoreal as jphotoreal
from epivo_tpu.parallel import global_ba as jgba
from epivo_tpu.pipeline import runners as jrunners
from epivo_tpu.pipeline.config import (BAConfig as JBAConfig, FrontendConfig, GlobalBAConfig,
                                       LMConfig, RansacConfig)
from epivo_tpu.geometry.camera import Pinhole as JPinhole
from epivo_tpu_torch import convert
from epivo_tpu_torch.geometry import epipolar as tepi, se3 as tse3
from epivo_tpu_torch.parallel import global_ba as tgba
from epivo_tpu_torch.pipeline import runners as trunners
from tests.test_global_ba import chain_scene, rot_errs

# Parallel test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _solve(scene, **kw):
    return tgba.global_ba_solve(_t(scene.T0s), np.asarray(scene.reps), _t(scene.p),
                                _t(scene.p_t), huber_delta=1.0, **kw)


def test_global_ba_recovery():
    scene = chain_scene(jax.random.PRNGKey(0))
    res = _solve(scene, max_span=2, max_iters=25, cg_iters=40)
    init = rot_errs(scene.T0s, scene.Ts)
    fin = rot_errs(res.T0s.numpy(), scene.Ts)
    assert np.median(fin) < 0.1 * np.median(init), (init, fin)
    assert int(res.n_accepted) > 3


def test_global_ba_long_span():
    scene = chain_scene(jax.random.PRNGKey(1), n_zeta=8, span=3)
    res = _solve(scene, max_span=3, max_iters=25, cg_iters=40)
    init = rot_errs(scene.T0s, scene.Ts)
    fin = rot_errs(res.T0s.numpy(), scene.Ts)
    assert np.median(fin) < 0.15 * np.median(init)


def test_global_ba_span_guard():
    scene = chain_scene(jax.random.PRNGKey(2), n_zeta=6, span=3)
    with pytest.raises(ValueError, match="max_span"):
        _solve(scene, max_span=2)


def test_global_ba_mesh_refused():
    scene = chain_scene(jax.random.PRNGKey(2), n_zeta=6, span=2)
    # The mesh path is ported (tests/test_torch_dist.py runs it); a mesh
    # that is not a torch.distributed DeviceMesh is refused.
    with pytest.raises(TypeError, match="DeviceMesh"):
        _solve(scene, max_span=2, mesh=object())


def _energy(Ts, scene):
    """The reference test's energy: sum of squared residuals over the
    composed spans, from the dense prefix table."""
    T0_mem = tse3.prefix_products(_t(Ts))
    z0, z1 = scene.reps[:, 0], scene.reps[:, 1]
    T = T0_mem[np.minimum(z0, z1), np.maximum(z0, z1)]
    rev = torch.from_numpy(np.asarray(z0 > z1))
    T = torch.where(rev[:, None, None], tse3.inverse(T), T)
    r = tepi.residual_from_T(T, _t(scene.p), _t(scene.p_t), 1.0)
    return float(torch.sum(r.double() ** 2))


def test_global_ba_decreases_energy():
    scene = chain_scene(jax.random.PRNGKey(4), n_zeta=16, N=12, span=2)
    res = _solve(scene, max_span=2, max_iters=20, cg_iters=32)
    assert _energy(res.T0s, scene) < 0.2 * _energy(scene.T0s, scene)


@pytest.mark.parametrize("seed,n_zeta,span", [(0, 12, 2), (1, 8, 3), (3, 9, 2)])
def test_global_ba_matches_reference(seed, n_zeta, span):
    scene = chain_scene(jax.random.PRNGKey(seed), n_zeta=n_zeta, span=span)
    w = np.ones(scene.reps.shape[0], np.float32)
    w[::5] = 0.0  # some zero-weight constraints, as the runner's underfilled ones
    kw = dict(max_span=span, max_iters=15, cg_iters=32, huber_delta=1.0)
    res_j = jgba.global_ba_solve(scene.T0s, scene.reps, scene.p, scene.p_t,
                                 wreps=jnp.asarray(w), **kw)
    res_t = tgba.global_ba_solve(_t(scene.T0s), np.asarray(scene.reps), _t(scene.p),
                                 _t(scene.p_t), wreps=torch.from_numpy(w), **kw)
    np.testing.assert_allclose(res_t.T0s.numpy(), np.asarray(res_j.T0s), atol=5e-3)
    r_j = float(res_j.r_norm)
    assert abs(float(res_t.r_norm) - r_j) < max(1e-6, 0.05 * r_j)
    # A repeat is bit-equal.
    again = tgba.global_ba_solve(_t(scene.T0s), np.asarray(scene.reps), _t(scene.p),
                                 _t(scene.p_t), wreps=torch.from_numpy(w), **kw)
    assert torch.equal(again.T0s, res_t.T0s) and torch.equal(again.r_norm, res_t.r_norm)


def test_prefix_band_matches_dense_prefix_products():
    rng = np.random.default_rng(0)
    Ts = tse3.se3_exp(torch.from_numpy(rng.normal(0, 0.3, (9, 6)).astype(np.float32)))
    dense = tse3.prefix_products(Ts)
    for width in (1, 2, 4, 12):
        band = tgba.prefix_band(Ts, width)
        assert band.shape == (width, 9, 4, 4)
        for d in range(width):
            for j in range(9):
                want = dense[j, j + d] if j + d < 9 else torch.eye(4)
                np.testing.assert_allclose(band[d, j].numpy(), want.numpy(), atol=2e-6)
        # Entries below the diagonal read as identity, as in the dense table.
        j, k = torch.tensor([[3, 5]]), torch.tensor([[2, 5]])
        got = tgba._band_at(band, j, k)
        np.testing.assert_array_equal(got[0, 0].numpy(), np.eye(4, dtype=np.float32))
        np.testing.assert_array_equal(got[0, 1].numpy(), dense[5, 5].numpy())


H, W = 180, 240
F = 11


def _ba_configs():
    cam = JPinhole(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, width=W, height=H)
    cfg0 = JBAConfig(camera=cam,
                     frontend=FrontendConfig(fast_threshold=12.0, max_keypoints=256,
                                             klt_levels=3),
                     ransac=RansacConfig(n_hyp=256),
                     lm=LMConfig(n_points=32, revert_r_norm=1e-2))
    cfg1 = dataclasses.replace(cfg0, global_ba=GlobalBAConfig(enabled=True, max_iters=10,
                                                              cg_iters=16))
    return cfg0, cfg1


@pytest.fixture(scope="module")
def runner_stage(tmp_path_factory):
    """The port's run_ba_sequence on the reference test's 11-frame corridor
    with the polish off and on (same seed, so the same pairs)."""
    K = np.array([[200.0, 0, W / 2], [0, 200.0, H / 2], [0, 0, 1.0]])
    frames, _, _ = jphotoreal.corridor_sequence(F, H=H, W=W, K=K, speed=0.5, seed=4)
    frames = [np.asarray(f) for f in frames]
    cfg0, cfg1 = (convert.config_from_reference(c) for c in _ba_configs())
    mp = str(tmp_path_factory.mktemp("gba") / "m.jsonl")
    res0 = trunners.run_ba_sequence(list(frames), cfg0, n_frames=F, seed=0, device="cpu")
    res1 = trunners.run_ba_sequence(list(frames), cfg1, n_frames=F, seed=0, device="cpu",
                                    metrics_path=mp)
    return res0, res1, [json.loads(line) for line in open(mp)]


def test_refine_global_runner_stage(runner_stage):
    """Twin of tests/test_global_ba.py::test_refine_global_runner_stage
    (without its mesh part): keep_norms, the rotations moved, one health
    line."""
    res0, res1, stages = runner_stage
    assert np.all(np.isfinite(res1.trajectory))
    assert res1.trajectory.shape == res0.trajectory.shape
    d0 = np.linalg.norm(np.diff(res0.trajectory[:, :3, 3], axis=0), axis=-1)
    d1 = np.linalg.norm(np.diff(res1.trajectory[:, :3, 3], axis=0), axis=-1)
    np.testing.assert_allclose(d1, d0, rtol=1e-3, atol=1e-5)
    assert not np.allclose(res1.trajectory, res0.trajectory)
    gba_lines = [s for s in stages if s.get("stage") == "global_ba"]
    assert len(gba_lines) == 1 and gba_lines[0]["n_constraints"] > 0
    assert len([s for s in stages if s.get("stage") == "global_ba_wall"]) == 1
    assert res1.stats["global_ba_s"] > 0 and "global_ba_s" not in res0.stats


def _rot_dir(z):
    z = np.asarray(z, np.float64)
    return z[:, :3, :3], z[:, :3, 3] / np.linalg.norm(z[:, :3, 3], axis=-1, keepdims=True)


def test_refine_global_matches_reference(runner_stage):
    """The same zetas and pairs through both packages' refine_global."""
    res0 = runner_stage[0]
    traj = res0.trajectory.astype(np.float64)
    # The windowed run's scaled zetas: traj[i+1] = traj[i] @ inv(zeta_i).
    zetas = (np.linalg.inv(traj[1:]) @ traj[:-1]).astype(np.float32)
    cfg1_j = _ba_configs()[1]
    z_j, r_j = jrunners.refine_global(zetas, res0.pair_data, cfg1_j)
    z_t, r_t = trunners.refine_global(zetas, res0.pair_data,
                                      convert.config_from_reference(cfg1_j), device="cpu")
    assert z_t.shape == zetas.shape and z_t.dtype == np.float32
    (R_j, d_j), (R_t, d_t) = _rot_dir(z_j), _rot_dir(z_t)
    assert np.abs(R_t - R_j).max() < 5e-4 and np.abs(d_t - d_j).max() < 1e-2
    np.testing.assert_allclose(np.linalg.norm(z_t[:, :3, 3], axis=-1),
                               np.linalg.norm(zetas[:, :3, 3], axis=-1), rtol=1e-5)
    assert abs(float(r_t.r_norm) - float(r_j.r_norm)) < max(1e-6, 0.05 * float(r_j.r_norm))
    assert int(r_t.n_accepted) > 0
    # No pair gives a constraint: the zetas come back untouched.
    same, none = trunners.refine_global(zetas, {}, convert.config_from_reference(cfg1_j),
                                        device="cpu")
    assert none is None and np.array_equal(same, zetas)
