"""The ORB describe kernel's premises and routing, on the CPU
(``epivo_tpu_torch/frontend/orb.py``, ``csrc/orb_describe.cu``).

The kernel (``orb.describe_kernel``) runs only on the card, where
``tests/test_torch_kernels_cuda.py`` holds it bit-equal to
``orb.describe_plain``; the port's describe is held to the JAX package's in
``tests/test_torch_orb.py``. Here, on windows of the repo's corridor frames
at full resolution and at a pyramid level (whose pixels are not integers):

- the float64 moments of ``orb.orientation`` are bit-equal summed in
  torch's order, in a random permutation of the pixels, in the kernel's
  order (32 lane-strided partial sums, then a 5-stage xor tree), in a
  block-wide order (256 lane-strided partial sums, a xor tree per warp,
  then the 8 warps in order) and exactly (``math.fsum``): the premise of
  the kernel's bit-equal angle;
- a numpy transcription of the kernel's per-test arithmetic (float32, one
  rounding per operation, in the kernel's order of terms, with the plain
  path's angle, cosine and sine) gives ``describe_plain``'s signs and
  packing bit for bit, and the kernel's integer circle is orientation's;
- ``describe(use_kernel=True)`` on a CPU tensor raises, and the plain path
  never moves ``orb.DESCRIBE_LAUNCHES``, which ``_graphs.COUNTERS`` lists
  so that graph replays count the kernel.
"""

import math

import numpy as np
import pytest
import torch

from epivo_tpu_torch import _graphs
from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.frontend import fast, image, klt, orb
from epivo_tpu_torch.pipeline import config, vo

# Parallel test workers share the CPU: one intra-op thread each.
torch.set_num_threads(1)

H, W = 188, 620
S, R = orb._S, orb._S // 2
LANES = 32


@pytest.fixture(scope="module")
def frames():
    fr, _, _ = photoreal.corridor_sequence(2, H=H, W=W, seed=0)
    return [torch.from_numpy(np.asarray(f, np.float32)) for f in fr]


def _level(img, lv):
    """Pyramid level ``lv`` of img as detect_and_describe_pyramid builds it."""
    for _ in range(lv):
        nh, nw = round(img.shape[-2] / 1.2), round(img.shape[-1] / 1.2)
        img = image.resize_linear(image._sep_conv3(img, (0.25, 0.5, 0.25),
                                                   (0.25, 0.5, 0.25)), nh, nw)
    return img


def _keypoints(img, n=96):
    """FAST keypoints of img, with border points and half-pixel centres
    (rint rounds those to even) appended."""
    h, w = img.shape
    kp = fast.detect(img, 20.0, n)
    extra = torch.tensor([[0.0, 0.0], [w - 1.0, h - 1.0], [18.5, 19.5], [w - 18.5, 20.5],
                          [-4.0, h + 3.0], [w / 2 + 0.5, 0.25], [2.5, h - 2.5]])
    return torch.cat([kp.xy, extra])


@pytest.fixture(scope="module", params=[0, 3], ids=["level0", "level3"])
def case(frames, request):
    img = _level(frames[0], request.param)
    return img, _keypoints(img)


def _circle():
    d = np.arange(S) - R
    return (d[None, :] ** 2 + d[:, None] ** 2) <= 240  # the kernel's kCircle


def _terms(wins):
    """[N, S*S] float64 terms v * dx and v * dy of the two moments, zero
    outside the circle, in window (row-major) order."""
    d = np.arange(S, dtype=np.float64) - R
    w = wins.astype(np.float64) * _circle()
    return (w * d[None, None, :]).reshape(len(w), -1), (w * d[None, :, None]).reshape(
        len(w), -1)


def _lane_order(t, threads):
    """Partial sums of ``threads`` lane-strided threads, a 5-stage xor tree
    in each warp, then the warp totals in order: orb_describe.cu's order
    with one warp (threads = 32), a block-wide one with 256."""
    n = t.shape[1]
    pad = np.zeros((len(t), -(-n // threads) * threads))
    pad[:, :n] = t
    acc = np.zeros((len(t), threads))
    for chunk in pad.reshape(len(t), -1, threads).transpose(1, 0, 2):
        acc = acc + chunk
    v = acc.reshape(len(t), threads // LANES, LANES)
    lanes = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    total = v[:, 0, 0]
    for w in range(1, threads // LANES):
        total = total + v[:, w, 0]
    return total


def test_moment_sums_do_not_depend_on_order(case):
    img, xy = case
    wins, _ = klt._extract_windows(img, xy, S, use_kernel=False)
    ang = orb.orientation(wins).numpy()
    wins = wins.numpy()
    perm = np.random.default_rng(0).permutation(S * S)
    for m, t in zip(("m10", "m01"), _terms(wins)):
        orders = {
            "torch": torch.from_numpy(t.reshape(-1, S, S)).sum(dim=(-2, -1)).numpy(),
            "permuted": np.cumsum(t[:, perm], axis=-1)[:, -1],
            "kernel": _lane_order(t, 32),
            "block": _lane_order(t, 256),
            "exact": np.array([math.fsum(row) for row in t]),
        }
        for name, got in orders.items():
            assert np.array_equal(got.view(np.int64), orders["exact"].view(np.int64)), (
                m, name)
    m10, m01 = (torch.from_numpy(_lane_order(t, 32)) for t in _terms(wins))
    assert torch.equal(torch.atan2(m01, m10).to(torch.float32), torch.from_numpy(ang))


def _kernel_model(img, xy):
    """orb_describe.cu's per-keypoint arithmetic in numpy float32, one
    rounding per operation in the kernel's order of terms; the angle, its
    cosine and sine from the plain path (libm's, not CUDA's)."""
    img, xy = img.numpy(), xy.numpy()
    h, w = img.shape
    c = np.rint(np.clip(xy, -1e8, 1e8)).astype(np.int64)
    ox, oy = np.clip(c[:, 0] - R, 0, w - S), np.clip(c[:, 1] - R, 0, h - S)
    wins = np.stack([img[y:y + S, x:x + S] for x, y in zip(ox, oy)])
    ang = orb.orientation(torch.from_numpy(wins))
    ca, sa = torch.cos(ang).numpy()[:, None], torch.sin(ang).numpy()[:, None]
    cx = (xy[:, 0] - ox.astype(np.float32))[:, None]
    cy = (xy[:, 1] - oy.astype(np.float32))[:, None]
    hi = np.float32(S - 1.001)
    k = np.arange(len(xy))[:, None]

    def tap(px, py):
        rx = ca * px - sa * py
        ry = sa * px + ca * py
        qx = np.minimum(np.maximum(cx + rx, np.float32(0)), hi)
        qy = np.minimum(np.maximum(cy + ry, np.float32(0)), hi)
        flx, fly = np.floor(qx), np.floor(qy)
        fx, fy = qx - flx, qy - fly
        gx, gy = np.float32(1) - fx, np.float32(1) - fy
        x0, y0 = flx.astype(np.int64), fly.astype(np.int64)
        col0 = gy * wins[k, y0, x0] + fy * wins[k, y0 + 1, x0]
        col1 = gy * wins[k, y0, x0 + 1] + fy * wins[k, y0 + 1, x0 + 1]
        return gx * col0 + fx * col1

    p = orb._PATTERN
    bits = tap(p[:, 0], p[:, 1]) > tap(p[:, 2], p[:, 3])
    words = (bits.reshape(len(xy), 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64))
    return np.where(bits, 1.0, -1.0).astype(np.float32), words.sum(-1).astype(np.uint32)


def test_kernel_arithmetic_matches_plain_describe(case):
    img, xy = case
    signs, packed = _kernel_model(img, xy)
    s_p, p_p, _ = orb.describe_plain(img, xy)
    assert np.array_equal(signs, s_p.numpy())
    assert np.array_equal(packed, p_p.numpy())
    r = torch.arange(S, dtype=torch.float64) - (S - 1) / 2.0
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    assert np.array_equal(_circle(), ((xx**2 + yy**2) <= (orb.PATCH / 2.0) ** 2).numpy())


def test_describe_routes(frames):
    img = frames[0]
    xy = _keypoints(img, 32)
    with pytest.raises(ValueError, match="CUDA"):
        orb.describe(img, xy, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        orb.describe_kernel(img, xy)
    d = orb.describe(img, xy)
    for a, b in zip(d[:3], orb.describe_plain(img, xy)):
        assert torch.equal(a, b)
    assert d.valid.all() and d.valid.shape == xy.shape[:-1]


def test_plain_paths_never_count_the_kernel(frames):
    assert ("epivo_tpu_torch.frontend.orb", "DESCRIBE_LAUNCHES") in _graphs.COUNTERS
    assert ("epivo_tpu_torch.frontend.orb", "DESCRIBE_LAUNCHES") in _graphs.launches()
    before = orb.DESCRIBE_LAUNCHES
    img = torch.stack(frames)
    xy = torch.stack([_keypoints(f, 32) for f in frames])
    orb.describe(img, xy)
    orb.describe(img, xy, use_kernel=False)
    orb.detect_and_describe_pyramid(img, 20.0, 256, n_levels=3)
    cfg = config.VOConfig(frontend=config.FrontendConfig(fast_threshold=20.0,
                                                         max_keypoints=128))
    vo.orb_associate(frames[0][None], frames[1][None], cfg)
    assert orb.DESCRIBE_LAUNCHES == before
