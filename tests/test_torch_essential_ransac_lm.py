"""Port parity: essential matrix, RANSAC and LM (epivo_tpu_torch vs epivo_tpu).

RANSAC samples come from the reference (``epivo_tpu.ransac._sample_indices``)
and are injected into the port, since torch cannot reproduce
``jax.random``. Tolerances: 1e-4 on E and poses (float32 through
eigen-solves and 30 LM iterations, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu import ransac as jransac
from epivo_tpu.geometry import essential as jess, se3 as jse3
from epivo_tpu.optim import lm as jlm
from epivo_tpu_torch import convert, ransac as transac
from epivo_tpu_torch.geometry import essential as tess
from epivo_tpu_torch.optim import lm as tlm


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _scene(seed, n=96, noise=5e-4, outliers=0.2):
    """Matched normalized points for a forward-moving relative pose, with
    pixel-like noise and a fraction of gross outliers."""
    rng = np.random.default_rng(seed)
    xi = np.array([0.05, -0.02, 0.6, 0.02, -0.03, 0.015], np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)), np.float64)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(5, 20, n)], -1)
    Xt = X @ T[:3, :3].T + T[:3, 3]
    p = X / X[:, 2:3]
    p_t = Xt / Xt[:, 2:3]
    p_t[:, :2] += rng.normal(0, noise, (n, 2))
    bad = rng.uniform(size=n) < outliers
    p_t[bad, :2] += rng.uniform(-0.2, 0.2, (bad.sum(), 2))
    return T.astype(np.float32), p.astype(np.float32), p_t.astype(np.float32)


def _up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = 1.0 if np.abs(a - b).max() <= np.abs(a + b).max() else -1.0
    np.testing.assert_allclose(a, s * b, atol=atol)


def test_eight_point_sampson_recover_pose():
    T, p, p_t = _scene(0, outliers=0.0)
    rng = np.random.default_rng(1)
    idx = np.stack([rng.choice(len(p), 8, replace=False) for _ in range(16)])
    for proj in (False, True):
        E_t = tess.eight_point(_t(p[idx]), _t(p_t[idx]), project=proj).numpy()
        E_j = np.asarray(jess.eight_point(jnp.asarray(p[idx]), jnp.asarray(p_t[idx]),
                                          project=proj))
        d = np.minimum(np.abs(E_t - E_j).max((1, 2)), np.abs(E_t + E_j).max((1, 2)))
        # A minimal sample of near-forward motion can have a tiny gap above
        # its null space, which amplifies float32 rounding of AtA: typical
        # hypotheses agree to 1e-6, the worst few to 1e-3.
        assert np.median(d) <= 1e-6 and d.max() <= 1e-3, d
    w = (rng.uniform(size=len(p)) > 0.3).astype(np.float32)
    E_t = tess.eight_point(_t(p), _t(p_t), weights=_t(w))
    E_j = jess.eight_point(jnp.asarray(p), jnp.asarray(p_t), weights=jnp.asarray(w))
    _up_to_sign(E_t.numpy(), E_j, 1e-4)

    err_t = tess.sampson_error(E_t, _t(p), _t(p_t))
    err_j = jess.sampson_error(E_j, jnp.asarray(p), jnp.asarray(p_t))
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), atol=1e-9, rtol=1e-3)

    mask = rng.uniform(size=len(p)) > 0.1
    R_t, t_t, f_t = tess.recover_pose(E_t, _t(p), _t(p_t), torch.from_numpy(mask))
    R_j, t_j, f_j = jess.recover_pose(E_j, jnp.asarray(p), jnp.asarray(p_t),
                                      jnp.asarray(mask))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(R_t.numpy(), T[:3, :3], atol=1e-2)


def test_refine_essential_and_pose_fallback():
    T, p, p_t = _scene(2, outliers=0.0, noise=1e-3)
    E0 = jess.eight_point(jnp.asarray(p), jnp.asarray(p_t))
    mask = np.ones(len(p), bool)
    mask[::7] = False
    E_j = jax.jit(jess.refine_essential)(E0, jnp.asarray(p), jnp.asarray(p_t),
                                         mask=jnp.asarray(mask))
    E_t = tess.refine_essential(_t(E0), _t(p), _t(p_t), mask=torch.from_numpy(mask))
    _up_to_sign(E_t.numpy(), E_j, 1e-4)

    rng = np.random.default_rng(3)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(size=(6, 3)).astype(np.float32))))
    t = rng.normal(size=(6, 3)).astype(np.float32)
    t[1] = 0.0
    for a, b in zip(tess.pose_fallback(_t(R), _t(t)),
                    jess.pose_fallback(jnp.asarray(R), jnp.asarray(t))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("method", ["ransac", "lmeds"])
def test_ransac_with_reference_samples(method):
    T, p, p_t = _scene(4)
    N, n_hyp = len(p), 128
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=N) > 0.1
    key = jax.random.PRNGKey(3)
    thr = (1.0 / 300.0) ** 2
    res_j = jax.jit(jransac.ransac_essential,
                    static_argnames=("n_hyp", "threshold", "method"))(
        key, jnp.asarray(p), jnp.asarray(p_t), n_hyp=n_hyp, threshold=thr,
        mask=jnp.asarray(mask), method=method)
    idx = np.asarray(jransac._sample_indices(key, n_hyp, N, jnp.asarray(mask)))
    res_t = transac.ransac_essential(
        None, _t(p), _t(p_t), n_hyp=n_hyp, threshold=thr,
        mask=torch.from_numpy(mask), method=method,
        samples=convert.ransac_samples_from_reference(idx))
    inl_j = np.asarray(res_j.inliers)
    inl_t = res_t.inliers.numpy()
    assert np.mean(inl_j == inl_t) >= 0.99
    assert abs(int(res_t.n_inliers) - int(res_j.n_inliers)) <= max(1, N // 100)
    _up_to_sign(res_t.E.numpy(), res_j.E, 1e-4)
    # The LMedS score is a median squared error far below the threshold:
    # compare it on the threshold's scale.
    np.testing.assert_allclose(float(res_t.best_score), float(res_j.best_score),
                               rtol=1e-3, atol=1e-3 * thr)


def test_ransac_own_samples_and_unported_solver():
    T, p, p_t = _scene(6)
    g = torch.Generator().manual_seed(0)
    res = transac.ransac_essential(g, _t(p), _t(p_t), n_hyp=128,
                                   threshold=(1.0 / 300.0) ** 2)
    R, t, _ = tess.recover_pose(res.E, _t(p), _t(p_t), mask=res.inliers)
    np.testing.assert_allclose(R.numpy(), T[:3, :3], atol=2e-2)
    assert int(res.n_inliers) >= 60
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transac.ransac_essential(g, _t(p), _t(p_t), solver="5pt")
    assert transac.n_iterations(0.99, 0.5) == jransac.n_iterations(0.99, 0.5)


@pytest.mark.parametrize("n_zeta", [1, 3])
def test_lm_solve_matches_reference(n_zeta):
    rng = np.random.default_rng(7 + n_zeta)
    N = 48
    xis = np.array([[0.05, -0.02, 0.6, 0.02, -0.03, 0.015]] * n_zeta, np.float32)
    Ts_true = np.asarray(jse3.se3_exp(jnp.asarray(xis)))
    reps = [(i, i) for i in range(n_zeta)] + [(0, n_zeta - 1)] * (n_zeta > 1) \
        + [(n_zeta - 1, 0)] * (n_zeta > 1)
    reps = np.array(reps, np.int32)
    p_all, pt_all = [], []
    for z0, z1 in reps:
        lo, hi = min(z0, z1), max(z0, z1)
        T = np.eye(4)
        for k in range(lo, hi + 1):
            T = Ts_true[k] @ T
        if z0 > z1:
            T = np.linalg.inv(T)
        X = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                      rng.uniform(5, 20, N)], -1)
        Xt = X @ T[:3, :3].T + T[:3, 3]
        p_all.append(X / X[:, 2:3])
        pt = Xt / Xt[:, 2:3]
        pt[:, :2] += rng.normal(0, 1e-3, (N, 2))
        pt_all.append(pt)
    p = np.stack(p_all).astype(np.float32)
    p_t = np.stack(pt_all).astype(np.float32)
    pmask = rng.uniform(size=p.shape[:2]) > 0.1
    noise = rng.normal(0, 0.02, (n_zeta, 6)).astype(np.float32)
    T0s = np.asarray(jse3.se3_exp(jnp.asarray(xis + noise)))

    # huber_delta 1e-5 is the pipeline's (LMConfig) default. In the purely
    # quadratic regime (delta 1.0) the minimum is a flat valley in which the
    # two packages' accept/reject decisions part on rounding after ~10
    # iterations, at equal energy.
    out_j = jax.jit(jlm.solve, static_argnames="huber_delta")(
        jnp.asarray(T0s), jnp.asarray(reps), jnp.asarray(p), jnp.asarray(p_t),
        pmask=jnp.asarray(pmask), huber_delta=1e-5)
    out_t = tlm.solve(_t(T0s), torch.from_numpy(reps), _t(p), _t(p_t),
                      pmask=torch.from_numpy(pmask), huber_delta=1e-5)
    # The epipolar energy is invariant to the global translation scale (the
    # two-view gauge) and barely sees the relative scales of a short chain,
    # so LM's drift along them is rounding noise: compare the rotations and
    # each pose's translation direction.
    T_t, T_j = out_t.T0s.numpy(), np.asarray(out_j.T0s)
    np.testing.assert_allclose(T_t[:, :3, :3], T_j[:, :3, :3], atol=1e-4)
    t_t, t_j = T_t[:, :3, 3], T_j[:, :3, 3]
    np.testing.assert_allclose(t_t / np.linalg.norm(t_t, axis=-1, keepdims=True),
                               t_j / np.linalg.norm(t_j, axis=-1, keepdims=True),
                               atol=1e-4)
    np.testing.assert_allclose(float(out_t.r_norm), float(out_j.r_norm), rtol=1e-2)
    assert int(out_t.n_accepted) > 0
    r_t, J_t = tlm.build_system(_t(T0s), torch.from_numpy(reps).long(),
                                torch.ones(len(reps)), _t(p), _t(p_t), 1.0,
                                torch.from_numpy(pmask))
    r_j, J_j = jax.jit(jlm.build_system, static_argnums=5)(
        jnp.asarray(T0s), jnp.asarray(reps), jnp.ones(len(reps)), jnp.asarray(p),
        jnp.asarray(p_t), 1.0, jnp.asarray(pmask))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-6)
    scale = max(1.0, float(np.abs(np.asarray(J_j)).max()))
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), atol=1e-5 * scale)
