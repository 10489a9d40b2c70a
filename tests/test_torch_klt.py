"""Port parity: pyramid, window extraction and KLT (epivo_tpu_torch vs epivo_tpu).

Tolerances: the pyramid and the window extraction are exact (the same
terms in the same order; a copy). The LK iterations match the reference's
``lax.scan`` body to 2e-6 (the bound the reference's own Pallas-vs-scan
test uses: float32 sums in another order), and tracking to 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.frontend import image as jimage, klt as jklt
from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.frontend import image as timage, klt as tklt


def _textured_pair():
    """The textured fixture of the reference's KLT kernel test."""
    rng = np.random.default_rng(3)
    H, W, K = 120, 160, 40
    img0 = np.cumsum(np.cumsum(rng.normal(size=(H, W)), 0), 1).astype(np.float32)
    img1 = np.roll(np.roll(img0, 2, 1), -2, 0)
    pts = rng.uniform(20, [W - 20, H - 20], size=(K, 2)).astype(np.float32)
    return img0, img1, pts


@pytest.mark.parametrize("kind", ["integer", "corridor"])
def test_pyramid_and_gradients_bit_exact(kind):
    if kind == "integer":
        img = np.random.default_rng(0).integers(0, 256, (75, 131)).astype(np.float32)
    else:
        frames, _, _ = photoreal.corridor_sequence(1, H=96, W=128, seed=2)
        img = next(frames)
    pyr_j = jimage.build_pyramid(jnp.asarray(img), 4)
    pyr_t = timage.build_pyramid(torch.from_numpy(img), 4)
    for a, b in zip(pyr_t, pyr_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(timage.scharr_gradients(torch.from_numpy(img)),
                    jimage.scharr_gradients(jnp.asarray(img))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("size", [34, 46])
def test_extract_windows_exact(size):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (94, 311)).astype(np.float32)
    # Centres inside, near and beyond the borders (origins clamp).
    centers = rng.uniform(-10, [321, 104], size=(50, 2)).astype(np.float32)
    w_j, o_j = jklt._extract_windows(jnp.asarray(img), jnp.asarray(centers), size,
                                     use_pallas=False)
    w_t, o_t = tklt._extract_windows(torch.from_numpy(img), torch.from_numpy(centers),
                                     size)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    # Batched form: each batch element gets its own windows.
    imgs = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    oy = torch.from_numpy(rng.integers(0, 94 - size + 1, (2, 7)))
    ox = torch.from_numpy(rng.integers(0, 311 - size + 1, (2, 7)))
    out = tklt.extract_windows(imgs, oy, ox, size)
    for b in range(2):
        for k in range(7):
            y, x = int(oy[b, k]), int(ox[b, k])
            np.testing.assert_array_equal(out[b, k].numpy(),
                                          imgs[b, y:y + size, x:x + size].numpy())


def test_extract_windows_plain_clamps_like_dynamic_slice():
    # Out-of-range origins clamp to [0, H - S] x [0, W - S]. dynamic_slice
    # clamps a start beyond the upper end the same way; a negative start it
    # reads from the end, so it gets the lower clip first, as the
    # reference's _extract_windows applies it.
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (60, 90)).astype(np.float32)
    size = 34
    oy = np.array([[-5, 0, 26, 27, 100, -40, 13]])
    ox = np.array([[-3, 56, 57, 200, 10, -1, 90]])
    out = tklt.extract_windows_plain(torch.from_numpy(img)[None], torch.from_numpy(oy),
                                     torch.from_numpy(ox), size)
    for k in range(oy.shape[1]):
        start = (max(int(oy[0, k]), 0), max(int(ox[0, k]), 0))
        ref = jax.lax.dynamic_slice(jnp.asarray(img), start, (size, size))
        np.testing.assert_array_equal(out[0, k].numpy(), np.asarray(ref))


def test_grad_batch_and_sampler_match_reference():
    rng = np.random.default_rng(2)
    S, win, K = 34, 21, 16
    wins = rng.normal(size=(K, S, S)).astype(np.float32)
    for a, b in zip(tklt._grad_batch(torch.from_numpy(wins)),
                    jklt._grad_batch(jnp.asarray(wins))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q = rng.uniform(0, S - win - 1, (K, 2)).astype(np.float32)
    P_j = jklt._sample_lanes(jnp.transpose(jnp.asarray(wins), (1, 2, 0)),
                             jnp.asarray(q), win)
    P_t = tklt._sample_patches(torch.from_numpy(wins), torch.from_numpy(q), win)
    np.testing.assert_allclose(P_t.numpy(), np.transpose(np.asarray(P_j), (2, 0, 1)),
                               atol=2e-6)


def test_lk_plain_matches_reference_scan_body():
    """The reference's scan body, built as its Pallas-vs-scan test builds it."""
    rng = np.random.default_rng(1)
    S, win, K, iters, eps = 34, 21, 130, 7, 0.01
    tgt = jnp.asarray(rng.normal(size=(S, S, K)).astype(np.float32))
    T = jnp.asarray(rng.normal(size=(win, win, K)).astype(np.float32))
    Ix = jnp.asarray(rng.normal(size=(win, win, K)).astype(np.float32))
    Iy = jnp.asarray(rng.normal(size=(win, win, K)).astype(np.float32))
    q0 = jnp.asarray(rng.uniform(0, S - win - 1.1, size=(K, 2)).astype(np.float32))

    hi = S - win - 1 - 1e-3
    Gxx = jnp.sum(Ix * Ix, (0, 1))
    Gxy = jnp.sum(Ix * Iy, (0, 1))
    Gyy = jnp.sum(Iy * Iy, (0, 1))
    det = Gxx * Gyy - Gxy * Gxy
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)

    def body(carry, _):
        q, done = carry
        P = jklt._sample_lanes(tgt, q, win)
        dI = P - T
        bx = jnp.sum(dI * Ix, (0, 1))
        by = jnp.sum(dI * Iy, (0, 1))
        dx = -(Gyy * bx - Gxy * by) * inv_det
        dy = -(-Gxy * bx + Gxx * by) * inv_det
        st = jnp.stack([dx, dy], -1)
        qn = jnp.where(done[:, None], q, jnp.clip(q + st, 0.0, hi))
        return (qn, done | (jnp.linalg.norm(st, axis=-1) < eps)), None

    (qf, _), _ = jax.lax.scan(
        body, (jnp.clip(q0, 0.0, hi), jnp.zeros(K, bool)), None, length=iters)
    errf = jnp.mean(jnp.abs(jklt._sample_lanes(tgt, qf, win) - T), (0, 1))

    lanes_to_k = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a), (2, 0, 1))))
    q_t, err_t = tklt.lk_iterate_plain(lanes_to_k(tgt), lanes_to_k(T), lanes_to_k(Ix),
                                       lanes_to_k(Iy), torch.from_numpy(np.array(q0)),
                                       win, iters, eps)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(qf), atol=2e-6)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(errf), atol=2e-6)


def test_track_level_matches_reference():
    img0, img1, pts = _textured_pair()
    a = jklt._track_level(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                          jnp.asarray(pts), 21, 6, 10, 0.01, 1e-4, use_pallas=False)
    b = tklt._track_level(torch.from_numpy(img0), torch.from_numpy(img1),
                          torch.from_numpy(pts), torch.from_numpy(pts), 21, 6, 10,
                          0.01, 1e-4)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), atol=1e-3)
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    np.testing.assert_allclose(b[2].numpy(), np.asarray(a[2]), atol=1e-3)


def test_track_matches_reference():
    img0, img1, pts = _textured_pair()
    valid = np.ones(len(pts), bool)
    valid[::5] = False
    fj = jklt.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                    valid=jnp.asarray(valid), levels=3, iters=12, use_pallas=False)
    ft = tklt.track(torch.from_numpy(img0), torch.from_numpy(img1),
                    torch.from_numpy(pts), valid=torch.from_numpy(valid), levels=3,
                    iters=12)
    np.testing.assert_allclose(ft.xy.numpy(), np.asarray(fj.xy), atol=1e-3)
    np.testing.assert_array_equal(ft.status.numpy(), np.asarray(fj.status))
    # The shift is (+2, -2) px: both packages track it.
    flow = ft.xy.numpy()[valid] - pts[valid]
    np.testing.assert_allclose(flow, np.broadcast_to([2.0, -2.0], flow.shape), atol=0.05)


def test_kernel_wrappers_refuse_cpu_tensors():
    wins = torch.zeros(4, 34, 34)
    patch = torch.zeros(4, 21, 21)
    with pytest.raises(ValueError, match="CUDA"):
        tklt.lk_iterate(wins, patch, patch, patch, torch.zeros(4, 2), 21, 3, 0.01,
                        use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tklt.extract_windows(torch.zeros(1, 40, 40), torch.zeros(1, 2, dtype=torch.long),
                             torch.zeros(1, 2, dtype=torch.long), 34, use_kernel=True)
    assert tklt.default_margins(4) == [6, 6, 6, 12]
