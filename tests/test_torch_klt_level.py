"""Port parity: one KLT pyramid level (epivo_tpu_torch vs epivo_tpu).

The plain level, :func:`klt.track_level_composed` with ``use_kernel=False``,
is the oracle of the level kernel ``csrc/klt_level.cu``, which runs only
on the card (``tests/test_torch_kernels_cuda.py``). Here it is held
against the reference's ``_track_level`` with ``use_pallas=False``: 1e-3
px on the new guess and the residual (float32 sums in another order,
as in ``test_torch_klt.py``), ``ok`` equal, integer window origins equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.frontend import klt as jklt
from epivo_tpu_torch.frontend import klt as tklt

WIN, ITERS, EPS, MIN_EIG = 21, 10, 0.01, 1e-4
H, W = 120, 160


def _textured(seed: int, shift: tuple[int, int]):
    """A random-walk texture and its copy shifted by (dx, dy) pixels."""
    rng = np.random.default_rng(seed)
    img0 = np.cumsum(np.cumsum(rng.normal(size=(H, W)), 0), 1).astype(np.float32)
    img1 = np.roll(np.roll(img0, shift[0], 1), shift[1], 0)
    return img0, img1


def _reference(img0, img1, pts, guess, margin, n_chunks):
    out = jklt._track_level(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
                            jnp.asarray(guess), WIN, margin, ITERS, EPS, MIN_EIG,
                            n_chunks=n_chunks, use_pallas=False)
    return [np.asarray(o) for o in out]


def _plain(img0, img1, pts, guess, margin, n_chunks):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    out = tklt._track_level(t(img0), t(img1), t(pts), t(guess), WIN, margin, ITERS,
                            EPS, MIN_EIG, n_chunks=n_chunks)
    return [o.numpy() for o in out]


def _assert_level_close(got, ref):
    np.testing.assert_allclose(got[0], ref[0], atol=1e-3)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], atol=1e-3)


@pytest.mark.parametrize("margin,n_chunks", [(6, 1), (12, 2)])
def test_batched_plain_level_matches_single_and_reference(margin, n_chunks):
    rng = np.random.default_rng(5)
    K = 24
    pairs = [_textured(3, (2, -2)), _textured(4, (-3, 1))]
    pts = rng.uniform(15, [W - 15, H - 15], size=(2, K, 2)).astype(np.float32)
    guess = (pts + rng.uniform(-1, 1, size=pts.shape)).astype(np.float32)
    src = np.stack([p[0] for p in pairs])
    tgt = np.stack([p[1] for p in pairs])
    batched = _plain(src, tgt, pts, guess, margin, n_chunks)
    for b in range(2):
        single = _plain(src[b], tgt[b], pts[b], guess[b], margin, n_chunks)
        for a, s in zip(batched, single):
            np.testing.assert_array_equal(a[b], s)
        _assert_level_close(single, _reference(src[b], tgt[b], pts[b], guess[b],
                                               margin, n_chunks))


def test_half_pixel_centres_round_half_to_even():
    img0, img1 = _textured(6, (1, 1))
    xs = np.array([40.5, 41.5, 60.5, 61.5, 80.5, 99.5], np.float32)
    ys = np.array([30.5, 31.5, 50.5, 51.5, 70.5, 85.5], np.float32)
    pts = np.stack([xs, ys], -1)
    S = WIN + 2 * 6 + 1
    _, o_t = tklt._extract_windows(torch.from_numpy(img0), torch.from_numpy(pts), S)
    expect = np.stack([np.round(xs), np.round(ys)], -1) - S // 2  # half to even
    np.testing.assert_array_equal(o_t.numpy(), expect)
    _, o_j = jklt._extract_windows(jnp.asarray(img0), jnp.asarray(pts), S)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    # The guesses sit on half pixels too, so the target origins round the same way.
    guess = pts + np.float32(1.0)
    _assert_level_close(_plain(img0, img1, pts, guess, 6, 1),
                        _reference(img0, img1, pts, guess, 6, 1))


def test_border_keypoints_match_reference():
    img0, img1 = _textured(7, (-2, 3))
    pts = np.array([[0.0, 0.0], [0.4, 60.0], [2.0, 2.0], [W - 1, H - 1],
                    [W - 3.3, 10.0], [80.0, H - 0.6], [-3.0, 50.0], [W + 2.5, 40.0],
                    [70.0, -4.2], [17.0, 17.0]], np.float32)
    guess = (pts + np.array([-2.0, 3.0], np.float32)).astype(np.float32)
    _assert_level_close(_plain(img0, img1, pts, guess, 6, 1),
                        _reference(img0, img1, pts, guess, 6, 1))


def test_level_kernel_refuses_cpu_tensors():
    img = torch.zeros(1, 64, 64)
    pts = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tklt.track_level_kernel(img, img, pts, pts, WIN, 6, ITERS, EPS, MIN_EIG)
    with pytest.raises(ValueError, match="CUDA"):
        tklt._track_level(img[0], img[0], pts[0], pts[0], WIN, 6, ITERS, EPS, MIN_EIG,
                          use_kernel=True)
