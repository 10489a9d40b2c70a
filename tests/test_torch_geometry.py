"""Port parity: geometry and small linear algebra (epivo_tpu_torch vs epivo_tpu).

The same numpy inputs, made from a seed, go through the JAX function and
its PyTorch counterpart. Tolerance: atol 1e-5 on O(1) quantities (float32
with sums in another order), stated per assertion.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.geometry import camera as jcam, epipolar as jep, linalg3 as jl3, se3 as jse3
from epivo_tpu.optim import smallchol as jchol
from epivo_tpu_torch.geometry import camera as tcam, epipolar as tep, linalg3 as tl3, se3 as tse3
from epivo_tpu_torch.optim import smallchol as tchol

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(t_out, j_out, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               atol=atol, rtol=rtol)


def _xi(rng, n, rot=0.3, trans=1.0):
    return np.concatenate([rng.normal(size=(n, 3)) * trans,
                           rng.normal(size=(n, 3)) * rot], -1).astype(np.float32)


def _scene(rng, n=64):
    """A random relative pose and n matched normalized points in front of
    both cameras."""
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        np.array([0.1, -0.05, 0.5, 0.03, -0.04, 0.02], np.float32))))
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 12, n)], -1)
    Xt = X @ T[:3, :3].T + T[:3, 3]
    p = (X / X[:, 2:3]).astype(np.float32)
    p_t = (Xt / Xt[:, 2:3]).astype(np.float32)
    return T.astype(np.float32), p, p_t


@pytest.mark.parametrize("small", [False, True])
def test_se3_exp_log_inverse(small):
    rng = np.random.default_rng(0)
    xi = _xi(rng, 16, rot=1e-4 if small else 0.4)
    T_j = jse3.se3_exp(jnp.asarray(xi))
    T_t = tse3.se3_exp(_t(xi))
    _close(T_t, T_j)
    _close(tse3.se3_log(T_t), jse3.se3_log(T_j), atol=5e-5)
    _close(tse3.inverse(T_t), jse3.inverse(T_j))
    _close(tse3.so3_exp(_t(xi[:, 3:])), jse3.so3_exp(jnp.asarray(xi[:, 3:])))


def test_prefix_products_and_chain():
    rng = np.random.default_rng(1)
    Ts = np.asarray(jse3.se3_exp(jnp.asarray(_xi(rng, 4, rot=0.2, trans=0.5))))
    _close(tse3.prefix_products(_t(Ts)), jse3.prefix_products(jnp.asarray(Ts)))
    for rev in (False, True):
        _close(tse3.chain_compose(_t(Ts), rev),
               jse3.chain_compose(jnp.asarray(Ts), rev))
    _close(tse3.generators(), jse3.generators(), atol=0)


def test_svd3_and_eigh3():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32)
    for t_out, j_out in zip(tl3.svd3(_t(M)), jl3.svd3(jnp.asarray(M))):
        _close(t_out, j_out, atol=1e-4)
    A = M @ np.swapaxes(M, -1, -2)
    w_t, V_t = tl3.sym_eigh3_desc(_t(A))
    w_j, V_j = jl3.sym_eigh3_desc(jnp.asarray(A))
    _close(w_t, w_j, atol=1e-4, rtol=1e-5)
    _close(V_t, V_j, atol=1e-3)
    _close(tl3.det3(_t(M)), jnp.linalg.det(jnp.asarray(M)), atol=1e-5, rtol=1e-5)


def test_smallchol():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(32, 6, 6)).astype(np.float32)
    H = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(32, 6)).astype(np.float32)
    _close(tchol.solve_spd_small(_t(H), _t(b)),
           jchol.solve_spd_small(jnp.asarray(H), jnp.asarray(b)), atol=1e-4)
    _close(tchol.inv_spd_small(_t(H)), jchol.inv_spd_small(jnp.asarray(H)),
           atol=1e-4)
    # The sqrt guard keeps a non-SPD input finite (torch.linalg.cholesky raises).
    bad = -np.eye(6, dtype=np.float32)[None]
    assert torch.isfinite(tchol.solve_spd_small(_t(bad), _t(b[:1]))).all()


def test_epipolar_residual_triangulate_depth():
    rng = np.random.default_rng(4)
    T, p, p_t = _scene(rng)
    p_t = p_t + rng.normal(0, 1e-3, p_t.shape).astype(np.float32) * [1, 1, 0]
    mask = rng.uniform(size=p.shape[0]) > 0.2
    R, t = T[:3, :3], T[:3, 3]
    for delta in (1e-5, 1.0):
        _close(tep.residual(_t(R), _t(t), _t(p), _t(p_t), delta, torch.from_numpy(mask)),
               jep.residual(jnp.asarray(R), jnp.asarray(t), jnp.asarray(p),
                            jnp.asarray(p_t), delta, jnp.asarray(mask)), atol=1e-7)
    _close(tep.residual_from_T(_t(T), _t(p), _t(p_t), 1.0),
           jep.residual_from_T(jnp.asarray(T), jnp.asarray(p), jnp.asarray(p_t), 1.0),
           atol=1e-7)
    for t_out, j_out in zip(tep.triangulate(_t(R), _t(t), _t(p), _t(p_t)),
                            jep.triangulate(jnp.asarray(R), jnp.asarray(t),
                                            jnp.asarray(p), jnp.asarray(p_t))):
        _close(t_out, j_out, atol=ATOL, rtol=1e-5)
    d_t, v_t = tep.epipolar_depth(_t(R), _t(t), _t(p), _t(p_t))
    d_j, v_j = jep.epipolar_depth(jnp.asarray(R), jnp.asarray(t), jnp.asarray(p),
                                  jnp.asarray(p_t))
    _close(d_t, d_j, atol=ATOL, rtol=1e-5)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    s = np.linspace(0, 3, 50).astype(np.float32)
    _close(tep.huber(_t(s), 0.5), jep.huber(jnp.asarray(s), 0.5), atol=1e-7)
    _close(tep.huber_deriv(_t(s), 0.5), jep.huber_deriv(jnp.asarray(s), 0.5),
           atol=1e-7)
    _close(tep.pbar(_t(p_t)), jep.pbar(jnp.asarray(p_t)), atol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_residual_jacobian_matches_reference_and_ad(reverse):
    rng = np.random.default_rng(5)
    T, p, p_t = _scene(rng, 32)
    p_t = p_t + rng.normal(0, 1e-3, p_t.shape).astype(np.float32) * [1, 1, 0]
    Tl = np.asarray(jse3.se3_exp(jnp.asarray(_xi(rng, 1, 0.1, 0.3)[0])))
    Tr = np.linalg.inv(Tl) @ T
    delta = 1.0
    J_t = tep.residual_jacobian(_t(Tl), _t(Tr), _t(p), _t(p_t), reverse, delta)
    J_j = jep.residual_jacobian(jnp.asarray(Tl), jnp.asarray(Tr), jnp.asarray(p),
                                jnp.asarray(p_t), reverse, delta)
    scale = float(np.abs(np.asarray(J_j)).max())
    _close(J_t, J_j, atol=ATOL * max(1.0, scale))

    # Against forward-mode AD of the residual through T(eps) = Tl exp(+-eps) Tr.
    sign = -1.0 if reverse else 1.0

    def res(eps):
        Tc = _t(Tl) @ tse3.se3_exp(sign * eps) @ _t(Tr)
        return tep.residual_from_T(Tc, _t(p), _t(p_t), delta)

    J_ad = torch.func.jacfwd(res)(torch.zeros(6))
    np.testing.assert_allclose(J_t.numpy(), J_ad.numpy(), atol=2e-4 * max(1.0, scale))


def test_camera_normalize_roundtrip():
    rng = np.random.default_rng(6)
    pix = rng.uniform(0, 1000, (20, 2)).astype(np.float32)
    cam_t = tcam.KITTI_00
    cam_j = jcam.KITTI_00
    _close(cam_t.K_inv(), cam_j.K_inv(), atol=0)
    p_t = tcam.normalize(_t(pix), cam_t.K_inv())
    _close(p_t, jcam.normalize(jnp.asarray(pix), cam_j.K_inv()), atol=1e-6)
    _close(tcam.denormalize(p_t, cam_t.K()), pix, atol=1e-3)
    K64 = np.array([[cam_j.fx, 0, cam_j.cx], [0, cam_j.fy, cam_j.cy], [0, 0, 1]])
    assert tcam.Pinhole.from_K(K64) == tcam.Pinhole(cam_j.fx, cam_j.fy,
                                                    cam_j.cx, cam_j.cy)
