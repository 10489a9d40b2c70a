"""Port parity: the batched LM (``lm.solve_batched``, window axis first)
against both batched solvers of the JAX package, ``lm.solve_batched`` (a
``jax.vmap`` of ``solve``) and ``lm_lanes.solve_batched_lanes`` (its
lane-major twin).

Windows come from ``epivo_tpu.datasets.synthetic.gen_scene_sequence``
(two poses per window), converted to numpy, with the pipeline's
huber_delta 1e-5. Tolerances are those of the reference's own twin test
(``tests/test_lm_lanes.py``): poses atol 3e-3, r_norm rtol 0.2 and atol
1e-5, accepted-step counts within 8 (f32 accept/reject decisions part on
rounding inside the converged basin). A frozen pose (``zeta_mask``) stays
exactly at its initial value. One window of the batch equals a W = 1
solve to 1e-6 (the same operations on a batch of one). The batched
helpers (``prefix_products``, ``build_system``) equal their per-window
results to 1e-6, and the unrolled Cholesky at D = 12 (two poses) solves to
a relative 1e-4 of float64 ``numpy.linalg.solve``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.datasets import synthetic
from epivo_tpu.geometry import se3 as jse3
from epivo_tpu.optim import lm as jlm, lm_lanes
from epivo_tpu_torch.geometry import se3 as tse3
from epivo_tpu_torch.optim import lm as tlm, smallchol

W = 5
MONO_REPS = [(0, 0), (1, 1), (0, 1)]
# Forward spans, plus a reversed span over both poses.
REPS = {"forward": MONO_REPS, "reversed": MONO_REPS + [(1, 0)]}
HUBER = 1e-5


def _windows(seed, reps, N=24):
    keys = jax.random.split(jax.random.PRNGKey(seed), W)
    scenes = [synthetic.gen_scene_sequence(k, N=N, n_zeta=2, reps=reps,
                                           rot_noise=0.04, t_noise=0.08)
              for k in keys]
    return [np.stack([np.asarray(getattr(s, f)) for s in scenes])
            for f in ("T0s", "p", "p_t")]


def _masks(case, p):
    """wreps (with a zero), pmask and zeta_mask for the reversed case."""
    if case == "forward":
        return None, None, None
    rng = np.random.default_rng(2)
    wreps = rng.uniform(0.5, 1.5, p.shape[:2]).astype(np.float32)
    wreps[1, 2] = 0.0
    pmask = rng.uniform(size=p.shape[:3]) > 0.2
    return wreps, pmask, np.array([True, False])


def _opt(x, f=jnp.asarray):
    return None if x is None else f(x)


@pytest.mark.parametrize("case", ["forward", "reversed"])
def test_solve_batched_matches_both_reference_solvers(case):
    reps = np.asarray(REPS[case], np.int32)
    T0s, p, p_t = _windows(1 if case == "forward" else 2, REPS[case])
    wreps, pmask, zmask = _masks(case, p)
    kw = dict(max_iters=30, huber_delta=HUBER)

    out = tlm.solve_batched(
        torch.from_numpy(T0s), torch.from_numpy(reps), torch.from_numpy(p),
        torch.from_numpy(p_t), wreps=_opt(wreps, torch.from_numpy),
        pmask=_opt(pmask, torch.from_numpy), zeta_mask=_opt(zmask, torch.from_numpy),
        **kw)
    assert out.T0s.shape == (W, 2, 4, 4)
    assert all(f.shape == (W,) for f in out[1:])

    ref = jax.jit(lambda T, a, b, w, m: jlm.solve_batched(
        T, jnp.asarray(reps), a, b, wreps=w, pmask=m, zeta_mask=_opt(zmask), **kw))(
        jnp.asarray(T0s), jnp.asarray(p), jnp.asarray(p_t), _opt(wreps), _opt(pmask))
    lanes = lm_lanes.solve_batched_lanes(
        jnp.asarray(T0s), reps, jnp.asarray(p), jnp.asarray(p_t), wreps=_opt(wreps),
        pmask=_opt(pmask), zeta_mask=zmask, **kw)
    for other in (ref, lanes):
        np.testing.assert_allclose(out.T0s.numpy(), np.asarray(other.T0s), atol=3e-3)
        np.testing.assert_allclose(out.r_norm.numpy(), np.asarray(other.r_norm),
                                   rtol=0.2, atol=1e-5)
        d_acc = out.n_accepted.numpy().astype(int) - np.asarray(other.n_accepted)
        assert np.abs(d_acc).max() <= 8, d_acc
    assert int(out.n_accepted.min()) > 0
    if zmask is not None:
        assert torch.equal(out.T0s[:, 1], torch.from_numpy(T0s[:, 1]))


@pytest.mark.parametrize("case", ["forward", "reversed"])
def test_window_of_batch_equals_single_solve(case):
    reps = torch.tensor(REPS[case])
    T0s, p, p_t = (torch.from_numpy(a) for a in _windows(3, REPS[case]))
    wreps, pmask, zmask = (_opt(a, torch.from_numpy) for a in _masks(case, p))
    kw = dict(max_iters=30, huber_delta=HUBER, zeta_mask=zmask)
    out = tlm.solve_batched(T0s, reps, p, p_t, wreps=wreps, pmask=pmask, **kw)
    for w in (0, 3):
        one = tlm.solve(T0s[w], reps, p[w], p_t[w],
                        wreps=None if wreps is None else wreps[w],
                        pmask=None if pmask is None else pmask[w], **kw)
        np.testing.assert_allclose(one.T0s.numpy(), out.T0s[w].numpy(), atol=1e-6)
        np.testing.assert_allclose(float(one.r_norm), float(out.r_norm[w]),
                                   rtol=1e-6, atol=1e-12)
        assert int(one.n_accepted) == int(out.n_accepted[w])


def test_batched_helpers_match_per_window():
    reps = np.asarray(REPS["reversed"], np.int32)
    T0s, p, p_t = _windows(4, REPS["reversed"])
    wreps, pmask, _ = _masks("reversed", p)
    mem = tse3.prefix_products(torch.from_numpy(T0s))
    assert mem.shape == (W, 2, 2, 4, 4)
    r, J = tlm.build_system(torch.from_numpy(T0s), torch.from_numpy(reps).long(),
                            torch.from_numpy(wreps), torch.from_numpy(p),
                            torch.from_numpy(p_t), HUBER, torch.from_numpy(pmask))
    assert r.shape == (W, 4, 24) and J.shape == (W, 4, 24, 2, 6)
    for w in range(W):
        np.testing.assert_allclose(mem[w].numpy(), np.asarray(
            jse3.prefix_products(jnp.asarray(T0s[w]))), atol=1e-6)
        r_w, J_w = tlm.build_system(
            torch.from_numpy(T0s[w]), torch.from_numpy(reps).long(),
            torch.from_numpy(wreps[w]), torch.from_numpy(p[w]),
            torch.from_numpy(p_t[w]), HUBER, torch.from_numpy(pmask[w]))
        np.testing.assert_allclose(r[w].numpy(), r_w.numpy(), atol=1e-6)
        scale = max(1.0, float(J_w.abs().max()))
        np.testing.assert_allclose(J[w].numpy(), J_w.numpy(), atol=1e-6 * scale)


def test_unrolled_cholesky_at_twelve():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(W, 12, 12))
    H = A @ A.transpose(0, 2, 1) + 12.0 * np.eye(12)
    b = rng.normal(size=(W, 12))
    x = smallchol.solve_spd_small(torch.from_numpy(H.astype(np.float32)),
                                  torch.from_numpy(b.astype(np.float32))).numpy()
    x_ref = np.linalg.solve(H, b[..., None])[..., 0]
    assert np.abs(x - x_ref).max() <= 1e-4 * np.abs(x_ref).max()
