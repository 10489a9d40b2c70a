"""Port parity: the image helpers of ``frontend/image.py`` that only an
entry point needs (``bilinear_sample``, ``patch_coords``, ``extract_patch``,
``central_gradients``) against the JAX package's, on numpy-seeded images
and points (float32).

- ``patch_coords`` and ``central_gradients``: bit-equal (the same
  elementwise operations);
- ``bilinear_sample`` and ``extract_patch``, at points inside the image,
  on its border and outside it (clamped): within 1e-4 absolute on values
  in [0, 255] (the four-tap blend in float32, about 2 ulp at 255; the
  same floor, so the same taps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.frontend import image as jimage
from epivo_tpu_torch.frontend import image as timage

torch.set_num_threads(1)

H, W = 37, 53


def _image(seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(np.float32)


def _points(seed, shape):
    """Points over [-3, W + 3] x [-3, H + 3]: inside, on the border, outside,
    with some on integer coordinates."""
    rng = np.random.default_rng(seed)
    xy = np.empty(shape + (2,))
    xy[..., 0] = rng.uniform(-3.0, W + 3.0, shape)
    xy[..., 1] = rng.uniform(-3.0, H + 3.0, shape)
    xy.reshape(-1, 2)[::7] = np.round(xy.reshape(-1, 2)[::7])
    xy.reshape(-1, 2)[:4] = [[0.0, 0.0], [W - 1, H - 1], [W - 1.0000005, 0.5], [-1.0, H]]
    return xy.astype(np.float32)


@pytest.mark.parametrize("shape", [(200,), (4, 50)])
def test_bilinear_sample(shape):
    img, xy = _image(), _points(1, shape)
    ref = np.asarray(jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))
    out = timage.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("size", [1, 7, 8])
def test_patch_coords(size):
    c = _points(2, (3, 5))
    ref = np.asarray(jimage.patch_coords(jnp.asarray(c), size))
    out = timage.patch_coords(torch.from_numpy(c), size).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("size", [5, 8])
def test_extract_patch(size):
    img, c = _image(3), _points(4, (6,))
    ref = np.asarray(jimage.extract_patch(jnp.asarray(img), jnp.asarray(c), size))
    out = timage.extract_patch(torch.from_numpy(img), torch.from_numpy(c), size).numpy()
    assert out.shape == (6, size, size)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_central_gradients():
    img = _image(5)
    ref = [np.asarray(g) for g in jimage.central_gradients(jnp.asarray(img))]
    out = [g.numpy() for g in timage.central_gradients(torch.from_numpy(img))]
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
