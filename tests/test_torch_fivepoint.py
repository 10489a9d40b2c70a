"""Port parity: the batched 5-point solver (``geometry/fivepoint.py``).

The reference's solver compiles for minutes under ``jax.jit`` on the CPU,
so it runs eagerly here, once per module (the ``reference`` fixture), on
S = 16 minimal samples drawn with numpy. Each stage of the port is fed the
reference's own input to that stage. Tolerances:

- ``nullspace4``: the basis is not unique, so the subspaces are compared
  through their projectors, within 2e-4 (float32 inverse iteration
  behind a Cholesky factorization in another library);
- ``_constraint_matrix``: within 1e-5 of the largest coefficient (the
  port contracts one static cubic-form tensor, the reference expands
  monomial dicts: the same products summed in another order);
- ``_gauss_jordan_reduce``, ``_action_matrix_x``, ``_balance``,
  ``_det10`` / ``_charfn`` and ``_solve_gj``: within 1e-6 relative (the
  same operations in the same order; bit-equal on this CPU);
- ``_real_roots``: the same valid set per sample, roots within 1e-5 of
  the sample's spectral bound;
- ``five_point``: each sample's candidates as sets up to sign (candidate
  order is undefined): at least 90 % of each side's exact candidates
  (valid, with a Sampson error below 1e-5 on all 5 points) within 1e-3
  Frobenius of a valid candidate on the other side. The rest are close
  real-root pairs below the grid's resolution, where float32 bracketing
  moves with the order of sums (the source of the reference's own ~80 %
  per-sample recall), and samples whose action matrix balancing leaves a
  Gershgorin bound thousands of times the spectral radius, so that the
  grid misses the roots on one side (one of the 16 here).

The twins of ``tests/test_fivepoint.py:37-79`` (recall >= 70 % on 48 exact
minimal samples; every candidate satisfies its constraints and lies on
the essential manifold) run on the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.geometry import fivepoint as jfp
from epivo_tpu_torch.geometry import essential as tess, fivepoint as tfp

# Parallel test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

S = 16


def _so3(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def minimal_samples(seed: int, n: int):
    """n exact minimal problems: 5 points in front of both cameras of a
    random relative pose. Returns (p, p_t [n, 5, 3] float32, the true E of
    unit Frobenius norm [n, 3, 3])."""
    rng = np.random.default_rng(seed)
    ps, pts, Es = [], [], []
    for _ in range(n):
        R = _so3(rng.normal(size=3) * 0.15)
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = np.stack([rng.uniform(-3, 3, 5), rng.uniform(-2, 2, 5),
                      rng.uniform(4, 12, 5)], -1)
        Xt = X @ R.T + t
        ps.append(X / X[:, 2:])
        pts.append(Xt / Xt[:, 2:])
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = tx @ R
        Es.append(E / np.linalg.norm(E))
    return np.array(ps, np.float32), np.array(pts, np.float32), np.array(Es)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def reference():
    """The reference's stages on S minimal samples, run eagerly."""
    p, p_t, E_true = minimal_samples(0, S)
    J = jnp.asarray
    out = {"p": p, "p_t": p_t, "E_true": E_true}
    out["basis"] = np.asarray(jfp.nullspace4(J(p), J(p_t)))
    M = np.asarray(jfp._constraint_matrix(J(out["basis"])))
    out["M"] = M
    out["M_scaled"] = Ms = M / (np.abs(M).max(-1, keepdims=True) + 1e-30)
    C, ok = jfp._gauss_jordan_reduce(J(Ms))
    out["C"], out["ok"] = np.asarray(C), np.asarray(ok)
    out["Ax"] = Ax = np.asarray(jfp._action_matrix_x(C))
    Axb, d = jfp._balance(J(Ax))
    out["Axb"], out["d"] = Axb, d = np.asarray(Axb), np.asarray(d)
    out["radius"] = radius = np.abs(Axb).sum(-1).max(-1) + np.float32(1e-12)
    mu, root_ok = jfp._real_roots(J(Axb), J(radius))
    out["mu"], out["root_ok"] = np.asarray(mu), np.asarray(root_ok)
    out["lam"] = lam = (radius[:, None] * np.linspace(-1.0, 1.0, 33)[None]).astype(np.float32)
    out["charfn"] = np.asarray(jfp._charfn(J(Axb), J(lam)))
    Es, valid = jfp.five_point(J(p), J(p_t))
    out["Es"], out["valid"] = np.asarray(Es), np.asarray(valid)
    return out


def _projector(basis):
    B = np.asarray(basis, np.float64).reshape(basis.shape[0], 4, 9)
    return np.einsum("sai,saj->sij", B, B)


def test_nullspace4_spans_the_reference_subspace(reference):
    basis = tfp.nullspace4(_t(reference["p"]), _t(reference["p_t"])).numpy()
    np.testing.assert_allclose(_projector(basis), _projector(reference["basis"]), atol=2e-4)
    # Orthonormal, and null vectors of the 5x9 constraint rows.
    B = basis.reshape(S, 4, 9).astype(np.float64)
    np.testing.assert_allclose(B @ B.transpose(0, 2, 1), np.broadcast_to(np.eye(4), (S, 4, 4)),
                               atol=1e-5)
    A = tess.design_rows(_t(reference["p"]), _t(reference["p_t"])).numpy()
    assert np.abs(np.einsum("sni,sai->sna", A, B)).max() < 1e-4


def test_constraint_matrix_matches_reference(reference):
    M = tfp._constraint_matrix(_t(reference["basis"])).numpy()
    scale = np.abs(reference["M"]).max()
    np.testing.assert_allclose(M, reference["M"], atol=1e-5 * scale, rtol=0)


def test_reduction_and_action_matrix_match_reference(reference):
    C, ok = tfp._gauss_jordan_reduce(_t(reference["M_scaled"]))
    np.testing.assert_array_equal(ok.numpy(), reference["ok"])
    np.testing.assert_allclose(C.numpy(), reference["C"], rtol=1e-6,
                               atol=1e-6 * np.abs(reference["C"]).max())
    Ax = tfp._action_matrix_x(_t(reference["C"])).numpy()
    np.testing.assert_array_equal(Ax, reference["Ax"])


def test_balance_det_and_charfn_match_reference(reference):
    Axb, d = tfp._balance(_t(reference["Ax"]))
    np.testing.assert_allclose(Axb.numpy(), reference["Axb"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(d.numpy(), reference["d"], rtol=1e-6, atol=0)
    # Eigenvalues preserved by the similarity.
    ok = reference["ok"]
    ev_a = np.sort_complex(np.linalg.eigvals(reference["Ax"][ok].astype(np.float64)))
    ev_b = np.sort_complex(np.linalg.eigvals(Axb.numpy()[ok].astype(np.float64)))
    assert np.abs(ev_a - ev_b).max() < 1e-3 * np.abs(ev_a).max()
    ch = tfp._charfn(_t(reference["Axb"]), _t(reference["lam"])).numpy()
    ref = reference["charfn"]
    np.testing.assert_array_equal(np.isfinite(ch), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ch[fin], ref[fin], rtol=1e-6,
                               atol=1e-6 * np.abs(ref[fin]).max())
    # det10 against float64 LAPACK on well-conditioned matrices.
    A = (np.random.default_rng(1).normal(size=(S, 10, 10)) + 4 * np.eye(10)).astype(np.float32)
    det_t = tfp._det10(_t(A)).numpy()
    det_j = np.asarray(jfp._det10(jnp.asarray(A)))
    np.testing.assert_allclose(det_t, det_j, rtol=1e-6)
    np.testing.assert_allclose(det_t, np.linalg.det(A.astype(np.float64)), rtol=1e-4)


def test_real_roots_match_reference(reference):
    mu, valid = tfp._real_roots(_t(reference["Axb"]), _t(reference["radius"]))
    mu, valid = mu.numpy(), valid.numpy()
    np.testing.assert_array_equal(valid, reference["root_ok"])
    for s in range(S):
        a = np.sort(reference["mu"][s][valid[s]])
        b = np.sort(mu[s][valid[s]])
        assert np.all(np.abs(a - b) <= 1e-5 * reference["radius"][s]), (s, a, b)


def test_solve_gj_matches_reference_and_lapack():
    rng = np.random.default_rng(2)
    A = (rng.normal(size=(S, 10, 10)) + 4 * np.eye(10)).astype(np.float32)
    b = rng.normal(size=(S, 10)).astype(np.float32)
    x = tfp._solve_gj(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(x, np.asarray(jfp._solve_gj(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)
    x64 = np.linalg.solve(A.astype(np.float64), b[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(x, x64, atol=1e-3)


def _matched(A, va, B, vb, tol=1e-3):
    """(matched, total): valid candidates of A within ``tol`` Frobenius of a
    valid candidate of B of the same sample, up to sign."""
    hit = tot = 0
    for s in range(A.shape[0]):
        other = B[s][vb[s]]
        for E in A[s][va[s]]:
            tot += 1
            if len(other):
                d = np.minimum(np.linalg.norm(other - E, axis=(1, 2)),
                               np.linalg.norm(other + E, axis=(1, 2)))
                hit += d.min() < tol
    return hit, tot


def _exact(Es, valid, p, p_t):
    """Valid candidates that solve their minimal problem (Sampson error
    below 1e-5 on all 5 points)."""
    err = tess.sampson_error(_t(Es), _t(p)[:, None], _t(p_t)[:, None]).numpy()
    return valid & (err.max(-1) < 1e-5)


def test_five_point_candidates_match_reference_as_sets(reference):
    p, p_t = reference["p"], reference["p_t"]
    Es, valid = tfp.five_point(_t(p), _t(p_t))
    Es, valid = Es.numpy(), valid.numpy()
    assert Es.shape == (S, 10, 3, 3) and valid.shape == (S, 10)
    for A, va, B, vb in ((Es, valid, reference["Es"], reference["valid"]),
                         (reference["Es"], reference["valid"], Es, valid)):
        hit, tot = _matched(A, _exact(A, va, p, p_t), B, vb)
        assert tot >= 3 * S and hit >= 0.9 * tot, (hit, tot)


def test_five_point_recovers_true_solution():
    """Twin of tests/test_fivepoint.py: the true E is among the candidates
    for >= 70 % of random exact minimal samples."""
    p, p_t, E_true = minimal_samples(100, 48)
    Es, valid = tfp.five_point(_t(p), _t(p_t))
    Es, valid = Es.numpy(), valid.numpy()
    hits = 0
    for s in range(48):
        c = Es[s][valid[s]]
        if len(c):
            d = np.minimum(np.linalg.norm(c - E_true[s], axis=(1, 2)),
                           np.linalg.norm(c + E_true[s], axis=(1, 2)))
            hits += d.min() < 1e-2
    assert hits >= 0.7 * 48, hits


def test_five_point_candidates_satisfy_constraints():
    """Twin of tests/test_fivepoint.py: every valid candidate satisfies its
    5 epipolar constraints and lies on the essential manifold."""
    p, p_t, _ = minimal_samples(101, 16)
    Es, valid = tfp.five_point(_t(p), _t(p_t))
    err = tess.sampson_error(Es, _t(p)[:, None], _t(p_t)[:, None]).numpy()
    val = valid.numpy()
    assert val.any()
    flat = err[val].max(-1)
    # Most candidates are exact; the tail holds imprecise close-pair roots.
    assert np.quantile(flat, 0.9) < 1e-5, np.quantile(flat, 0.9)
    assert flat.max() < 1e-2, flat.max()
    good = val.copy()
    good[val] = flat < 1e-5
    Ev = Es.numpy()[good].astype(np.float64)
    assert np.abs(np.linalg.det(Ev)).max() < 1e-4
    EEt = Ev @ np.transpose(Ev, (0, 2, 1))
    tr = np.trace(EEt, axis1=1, axis2=2)
    G = 2.0 * EEt @ Ev - tr[:, None, None] * Ev
    assert np.abs(G).max() < 1e-3, np.abs(G).max()
