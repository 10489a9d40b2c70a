"""Port parity: the multi-device layer (``parallel/mesh.py``,
``parallel/dist.py``, ``ransac_essential(hyp_mesh=)`` and the
constraint-sharded ``global_ba_solve``) on gloo ranks on the CPU.

The ranks are spawned processes (``multihost.spawn``) running the rank
programs of ``epivo_tpu_torch/tools/mesh_checks.py``, one torch thread
each; the JAX side runs here, on conftest's 8 virtual devices.
Tolerances:

- ``make_mesh``: axis sizes, coordinates and groups exact;
- ``distributed_ba_step`` at 4 ranks on 8 windows of
  ``bench_ba_workload.npz``: ``T_opt`` and the trajectory within 5e-3 of
  the port's 1-rank solve (the reference's 1-vs-8 bound,
  ``tests/test_sharding.py:55,62``), the trajectory against
  ``ba.trajectory_from_zetas`` at 5e-3; against the JAX package's
  ``distributed_ba_step`` on its 8-device mesh at ``test_torch_ba.py``'s
  tolerances (rotations 1e-4, directions 3e-3, r_norm rtol 0.2 / atol
  1e-5, reverted equal, accepted steps within 8);
- ``distributed_ransac_essential`` at hyp = 2 with the reference's
  per-device samples: the same winning hypothesis (its E, a minimal
  8-point solve without the refit, within 5e-3 up to sign: the packages'
  float32 null vectors of one sample differ by ~1e-3), the inliers equal
  except where a Sampson error lies within 1 % of the threshold;
- ``ransac_essential(hyp_mesh=)`` at 2 ranks against no mesh on the same
  samples: the same winning hypothesis, E and inlier set (8- and
  5-point);
- ``global_ba_solve(mesh=)`` at 2 ranks: per-zeta rotation within 5e-3 of
  the port's 1-rank solve and of the JAX mesh path (the reference's
  ``tests/test_global_ba.py:80-82``), r_norm within 5 % or 1e-6, a repeat
  bit-equal;
- ``tools/dryrun_multichip.py`` at 4 ranks, (win=2, hyp=2), ends in its
  ok line.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu import ransac as jransac
from epivo_tpu.datasets import synthetic as jsynthetic
from epivo_tpu.geometry import essential as jessential
from epivo_tpu.parallel import dist as jdist, global_ba as jgba, mesh as jmesh
from epivo_tpu.pipeline import ba as jba, config as jconfig
from epivo_tpu_torch import convert, ransac as transac
from epivo_tpu_torch.geometry import essential as tess
from epivo_tpu_torch.parallel import multihost
from epivo_tpu_torch.pipeline import ba as tba
from epivo_tpu_torch.tools import mesh_checks
from tests.test_global_ba import chain_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = "epivo_tpu_torch.tools.mesh_checks"
SHAPES = [(4, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def groups():
    return multihost.spawn(mesh_checks.mesh_groups, 4, SHAPES)


@pytest.mark.parametrize("k", range(len(SHAPES)))
def test_make_mesh_axes_and_groups(groups, k):
    n_win, n_hyp = SHAPES[k]
    for rank, per_shape in enumerate(groups):
        g = per_shape[k]
        w, h = divmod(rank, n_hyp)
        assert g["shape"] == (n_win, n_hyp) and g["names"] == ("win", "hyp")
        assert (g["size_win"], g["size_hyp"]) == (n_win, n_hyp)
        assert (g["rank_win"], g["rank_hyp"]) == (w, h)
        assert g["group_win"] == [h + n_hyp * i for i in range(n_win)]
        assert g["group_hyp"] == [w * n_hyp + i for i in range(n_hyp)]


def _workload(n=8):
    z = np.load(os.path.join(REPO, "bench_ba_workload.npz"))
    return [z[k][:n] for k in ("T0s", "p", "p_t", "wreps", "pmask")]


def _bench_ba_config():
    return jconfig.BAConfig(lm=jconfig.LMConfig(n_points=32, max_iters=30,
                                                revert_r_norm=1e-2),
                            window_size=3, stride=2)


def _rot_dir(T):
    T = np.asarray(T, np.float64)
    t = T[..., :3, 3]
    return T[..., :3, :3], t / np.linalg.norm(t, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def ba_runs():
    arrays = _workload()
    cfg = convert.config_from_reference(_bench_ba_config())
    spec = tba.mono_window_spec(3)
    outs = multihost.spawn(mesh_checks.call_on_mesh, 4, f"{CHECKS}:ba_step", (4, 1),
                           tuple(torch.from_numpy(a) for a in arrays),
                           dict(spec=spec, config=cfg))
    t = [torch.from_numpy(a) for a in arrays]
    one = tba.ba_windows(t[0], spec, t[1], t[2], wreps=t[3], pmask=t[4], config=cfg)
    return arrays, [o[0] for o in outs], one


def test_distributed_ba_step_matches_one_rank(ba_runs):
    _, outs, one = ba_runs
    out = outs[0]
    d = np.abs(out.T_opt - one.T_opt.numpy()).max()
    print(f"4 ranks vs 1 rank: largest |dT_opt| {d:.3g}")
    np.testing.assert_allclose(out.T_opt, one.T_opt.numpy(), atol=5e-3)
    traj_1 = tba.trajectory_from_zetas(tba.stitch_windows(one.T_opt)).numpy()
    assert out.trajectory.shape == (8 * 2 + 1, 4, 4)
    np.testing.assert_allclose(out.trajectory, traj_1, atol=5e-3)
    traj_own = tba.trajectory_from_zetas(tba.stitch_windows(torch.from_numpy(out.T_opt)))
    np.testing.assert_allclose(out.trajectory, traj_own.numpy(), atol=5e-3)
    np.testing.assert_array_equal(out.reverted, one.reverted.numpy())
    np.testing.assert_allclose(out.global_r_norm,
                               np.sqrt(np.sum(out.r_norm.astype(np.float64) ** 2)), rtol=1e-5)
    assert float(out.reverted_frac) == float(out.reverted.mean())
    # Every rank holds the same (replicated) result.
    for o in outs[1:]:
        for a, b in zip(o, out):
            np.testing.assert_array_equal(a, b)


def test_distributed_ba_step_matches_reference(ba_runs):
    arrays, outs, _ = ba_runs
    out = outs[0]
    m8 = jmesh.make_mesh(n_win=8, n_hyp=1)
    ref = jdist.distributed_ba_step(m8, jba.mono_window_spec(3), _bench_ba_config())(
        *(jnp.asarray(a) for a in arrays))
    R_t, dir_t = _rot_dir(out.T_opt)
    R_j, dir_j = _rot_dir(ref.T_opt)
    np.testing.assert_allclose(R_t, R_j, atol=1e-4)
    np.testing.assert_allclose(dir_t, dir_j, atol=3e-3)
    np.testing.assert_allclose(out.r_norm, np.asarray(ref.r_norm), rtol=0.2, atol=1e-5)
    np.testing.assert_array_equal(out.reverted, np.asarray(ref.reverted))
    assert np.abs(out.n_accepted.astype(int) - np.asarray(ref.n_accepted)).max() <= 8
    assert out.trajectory.shape == tuple(ref.trajectory.shape)
    assert float(out.reverted_frac) == float(ref.reverted_frac)


def _outlier_scene(seed, N=96, n_out=24):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    T = jsynthetic.random_pose(k1)
    _, p, p_t = jsynthetic.gen_points(k2, N, T)
    p_t = p_t.at[:n_out, :2].add(jax.random.normal(k3, (n_out, 2)) * 0.3)
    return np.array(p), np.array(p_t), np.ones(N, bool)


def test_distributed_ransac_matches_reference():
    p, p_t, mask = _outlier_scene(2)
    D, n, thr = 2, 64, 1e-5
    m = jmesh.make_mesh(n_win=4, n_hyp=D)
    key = jax.random.PRNGKey(0)
    E_j, inl_j = jdist.distributed_ransac_essential(m, n_hyp_per_device=n, threshold=thr)(
        key, jnp.asarray(p), jnp.asarray(p_t), jnp.asarray(mask))
    # The reference's per-device draws: one key per hyp device.
    samples = np.stack([np.asarray(jransac._sample_indices(k, n, p.shape[0],
                                                           jnp.asarray(mask), 8))
                        for k in jax.random.split(key, D)])
    outs = multihost.spawn(mesh_checks.call_on_mesh, D, f"{CHECKS}:ransac_dist", (1, D),
                           (convert.ransac_samples_from_reference(samples),
                            torch.from_numpy(p), torch.from_numpy(p_t),
                            torch.from_numpy(mask), n, thr))
    E_t, inl_t = outs[0][0]
    E_j = np.array(E_j)
    # The same winning hypothesis: the port's is the one of its candidates
    # (for all D * n samples) that it returned; the reference's the first
    # maximum of its own per-hypothesis scores.
    flat = samples.reshape(-1, 8)
    c_t = tess.eight_point(torch.from_numpy(p)[flat], torch.from_numpy(p_t)[flat]).numpy()
    c_j = jessential.eight_point(jnp.asarray(p)[flat], jnp.asarray(p_t)[flat], project=True)
    err_j = jessential.sampson_error(c_j, jnp.asarray(p)[None], jnp.asarray(p_t)[None])
    win_j = int(np.argmax(np.sum(np.asarray(err_j) < thr, axis=-1)))
    hit = np.flatnonzero(np.all(c_t == E_t, axis=(1, 2)))
    assert hit.size and hit[0] == win_j, (hit, win_j)
    # Its E in the two packages: a minimal 8-point solve (no refit), whose
    # float32 rounding differs between them (~1e-3 here).
    sign = np.sign(np.sum(E_t * E_j))
    print(f"winner {win_j}: largest |dE| {np.abs(sign * E_t - E_j).max():.3g}")
    np.testing.assert_allclose(sign * E_t, E_j, atol=5e-3)
    err = np.asarray(tess.sampson_error(torch.from_numpy(E_j), torch.from_numpy(p),
                                        torch.from_numpy(p_t)))
    tie = np.abs(err - thr) < 0.01 * thr
    np.testing.assert_array_equal(inl_t[~tie], np.asarray(inl_j)[~tie])
    assert inl_t[24:].mean() > 0.9 and inl_t[:24].mean() < 0.2
    for o in outs[1:]:
        np.testing.assert_array_equal(o[0][0], E_t)
        np.testing.assert_array_equal(o[0][1], inl_t)


@pytest.mark.parametrize("solver,n_hyp", [("8pt", 128), ("5pt", 32)])
def test_ransac_hyp_mesh_same_winner(solver, n_hyp):
    p, p_t, mask = _outlier_scene(5)
    thr = 1e-5
    m = transac.SAMPLE_SIZE[solver]
    gen = torch.Generator().manual_seed(3)
    samples = transac._sample_indices(gen, n_hyp, p.shape[0], torch.from_numpy(mask), m)
    args = (None, torch.from_numpy(p), torch.from_numpy(p_t), n_hyp, thr,
            torch.from_numpy(mask))
    kw = dict(refit=False, solver=solver, samples=samples)
    outs = multihost.spawn(mesh_checks.call_on_mesh, 2, "epivo_tpu_torch.ransac:ransac_essential",
                           (1, 2), args, kw, "hyp_mesh", False, 1, True)
    for single, (meshed,) in outs:
        np.testing.assert_array_equal(meshed.E, single.E)
        np.testing.assert_array_equal(meshed.inliers, single.inliers)
        assert meshed.best_score == single.best_score
    # The winning hypothesis, found among the candidates of one rank.
    p_s, pt_s = (torch.from_numpy(q)[samples] for q in (p, p_t))
    if solver == "5pt":
        from epivo_tpu_torch.geometry import fivepoint

        cands = fivepoint.five_point(p_s, pt_s)[0].reshape(-1, 3, 3).numpy()
    else:
        cands = tess.eight_point(p_s, pt_s, project=True).numpy()
    hit = np.flatnonzero(np.all(cands == outs[0][1][0].E, axis=(1, 2)))
    assert hit.size >= 1 and outs[0][1][0].best_score > 0.5 * p.shape[0], hit


def _padded_chain(R_pad=24):
    scene = chain_scene(jax.random.PRNGKey(3), n_zeta=9, N=16, span=2)
    R0 = scene.reps.shape[0]
    pad = R_pad - R0
    reps = np.concatenate([scene.reps, np.zeros((pad, 2), np.int32)])
    p = np.concatenate([np.array(scene.p), np.ones((pad,) + scene.p.shape[1:], np.float32)])
    p_t = np.concatenate([np.array(scene.p_t),
                          np.ones((pad,) + scene.p_t.shape[1:], np.float32)])
    w = np.concatenate([np.ones(R0), np.zeros(pad)]).astype(np.float32)
    return np.array(scene.T0s), reps, p, p_t, w


def test_global_ba_mesh_matches_one_rank_and_reference():
    T0s, reps, p, p_t, w = _padded_chain()
    kw = dict(max_span=2, max_iters=15, cg_iters=32, huber_delta=1.0)
    outs = multihost.spawn(
        mesh_checks.call_on_mesh, 2, "epivo_tpu_torch.parallel.global_ba:global_ba_solve",
        (2, 1), (torch.from_numpy(T0s), reps, torch.from_numpy(p), torch.from_numpy(p_t)),
        dict(wreps=torch.from_numpy(w), **kw), "mesh", False, 2, True)
    single, (res, again) = outs[0]
    rot = lambda a, b: np.abs(a[:, :3, :3] - b[:, :3, :3]).max(axis=(1, 2))
    d1 = rot(res.T0s, single.T0s)
    print(f"2 ranks vs 1 rank: largest per-zeta rotation difference {d1.max():.3g}")
    assert d1.max() < 5e-3
    assert abs(float(res.r_norm) - float(single.r_norm)) < max(1e-6, 0.05 * float(single.r_norm))
    # A repeat is bit-equal, and both ranks hold the same result.
    for a, b in zip(again, res):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(outs[1][1][0], res):
        np.testing.assert_array_equal(a, b)
    ref = jgba.global_ba_solve(jnp.asarray(T0s), reps, jnp.asarray(p), jnp.asarray(p_t),
                               wreps=jnp.asarray(w), mesh=jmesh.make_mesh(n_win=8, n_hyp=1),
                               **kw)
    assert rot(res.T0s, np.asarray(ref.T0s)).max() < 5e-3
    r_j = float(ref.r_norm)
    assert abs(float(res.r_norm) - r_j) < max(1e-6, 0.05 * r_j)


def test_global_ba_mesh_needs_even_constraints():
    T0s, reps, p, p_t, w = _padded_chain(R_pad=17)  # 17 constraints on 2 ranks
    with pytest.raises(Exception, match="pad with zero-weight constraints"):
        multihost.spawn(
            mesh_checks.call_on_mesh, 2, "epivo_tpu_torch.parallel.global_ba:global_ba_solve",
            (2, 1), (torch.from_numpy(T0s), reps, torch.from_numpy(p), torch.from_numpy(p_t)),
            dict(wreps=torch.from_numpy(w), max_span=2))


def test_dryrun_multichip_cpu():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "epivo_tpu_torch.tools.dryrun_multichip",
                        "--ranks", "4", "--device", "cpu", "--backend", "gloo"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    print(r.stdout[-3000:])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multichip ok: mesh=(win=2, hyp=2)" in r.stdout.splitlines()[-1]
