"""Port parity: ORB descriptors (``frontend/orb.py``), Hamming matching
(``frontend/match.py``) and the ORB pyramid's resize (``image.resize_linear``).

Tolerances:

- the BRIEF pattern is bit-equal;
- ``orientation`` within 5e-4 rad of the reference on uniform-noise
  windows, whose two moments nearly cancel, so the angle carries the
  reference's float32 rounding (the port sums in float64; within 1e-4 rad
  on corridor keypoints);
- ``describe`` on a 96x128 corridor frame with 64 keypoints: every sign
  that differs from the reference's sits at a reference near-tie,
  |va - vb| < 1e-3 (intensities 0-255; the sample positions carry the
  angle's rounding); ``packed`` equals the packing of ``signs`` exactly,
  and B = 2 equals two B = 1 calls exactly;
- ``hamming_table`` and ``match`` exact (integer distances, ties broken to
  the first minimum as ``jnp.argmin`` does);
- the pyramid's level images within 2e-3 of the reference's (the resize's
  few nonzero terms per output summed in another order; values 0-255),
  and its keypoints per level equal on a 160x200 frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.datasets import photoreal as jphotoreal
from epivo_tpu.frontend import fast as jfast, image as jimage, klt as jklt, \
    match as jmatch, orb as jorb
from epivo_tpu_torch.frontend import image as timage, match as tmatch, orb as torb

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)

HS, WS = 96, 128


def _corridor_frame(H, W, seed=11):
    K = np.array([[110.0, 0, W / 2], [0, 110.0, H / 2], [0, 0, 1.0]])
    frames, _, _ = jphotoreal.corridor_sequence(2, H=H, W=W, K=K, speed=0.45, seed=seed)
    return [np.asarray(f, np.float32) for f in frames]


def test_pattern_bit_equal():
    assert torb.N_BITS == jorb.N_BITS and torb.PATCH == jorb.PATCH and torb._S == jorb._S
    assert np.array_equal(torb._PATTERN, jorb._PATTERN)
    assert np.array_equal(torb.brief_pattern(3), jorb.brief_pattern(3))


def test_orientation_matches_reference():
    wins = np.random.default_rng(0).uniform(0, 255, (200, 37, 37)).astype(np.float32)
    a_j = np.asarray(jorb.orientation(jnp.asarray(wins)))
    a_t = torb.orientation(torch.from_numpy(wins)).numpy()
    np.testing.assert_allclose(a_t, a_j, atol=5e-4)


def _reference_tests(img, xy):
    """The reference's describe, step by step, up to the two point samples
    (va, vb) [K, 256] that each sign compares."""
    wins, origins = jklt._extract_windows(img, xy, jorb._S)
    ang = jorb.orientation(wins)
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    pat = jnp.asarray(jorb._PATTERN)
    ctr = xy - origins

    def q(px, py):
        rx = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        ry = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        return jnp.stack([ctr[:, 0:1] + rx, ctr[:, 1:2] + ry], axis=-1)

    va = jorb._sample_points(wins, q(pat[:, 0], pat[:, 1]))
    vb = jorb._sample_points(wins, q(pat[:, 2], pat[:, 3]))
    return np.asarray(va), np.asarray(vb)


@pytest.fixture(scope="module")
def described():
    f0, f1 = _corridor_frame(HS, WS)
    out = []
    for f in (f0, f1):
        kp = jfast.detect(jnp.asarray(f), 12.0, 64)
        d_j = jorb.describe(jnp.asarray(f), kp.xy, kp.valid)
        xy, valid = torch.from_numpy(np.array(kp.xy)), torch.from_numpy(np.array(kp.valid))
        d_t = torb.describe(torch.from_numpy(f), xy, valid)
        out.append((f, kp, d_j, xy, valid, d_t))
    return out


def test_describe_matches_reference_up_to_near_ties(described):
    for f, kp, d_j, _, _, d_t in described:
        va, vb = _reference_tests(jnp.asarray(f), kp.xy)
        diff = d_t.signs.numpy() != np.asarray(d_j.signs)
        assert np.all(np.abs(va - vb)[diff] < 1e-3), np.abs(va - vb)[diff]
        assert diff.mean() < 0.01
        np.testing.assert_allclose(d_t.angle.numpy(), np.asarray(d_j.angle), atol=1e-4)
        np.testing.assert_array_equal(d_t.valid.numpy(), np.asarray(d_j.valid))
        same = ~diff.reshape(-1, 8, 32).any(-1)
        np.testing.assert_array_equal(d_t.packed.numpy()[same], np.asarray(d_j.packed)[same])


def test_describe_packing_exact(described):
    for *_, d_t in described:
        assert d_t.packed.dtype == torch.uint32 and d_t.packed.shape == (64, 8)
        bits = (d_t.signs.numpy() > 0).reshape(64, 8, 32).astype(np.uint64)
        expect = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
        np.testing.assert_array_equal(d_t.packed.numpy(), expect)
        assert set(np.unique(d_t.signs.numpy())) <= {-1.0, 1.0}


def test_describe_batch_equals_single_calls(described):
    imgs = torch.from_numpy(np.stack([d[0] for d in described]))
    xy = torch.stack([d[3] for d in described])
    valid = torch.stack([d[4] for d in described])
    d_b = torb.describe(imgs, xy, valid)
    for b, (*_, d_t) in enumerate(described):
        for a, s in zip(d_b, d_t):
            assert torch.equal(a[b], s)


def _signs(rng, n, bits=256):
    return np.where(rng.uniform(size=(n, bits)) < 0.5, -1.0, 1.0).astype(np.float32)


def test_hamming_table_exact():
    rng = np.random.default_rng(1)
    a, b = _signs(rng, 40), _signs(rng, 50)
    D_t = tmatch.hamming_table(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(D_t, np.asarray(jmatch.hamming_table(jnp.asarray(a),
                                                                       jnp.asarray(b))))
    np.testing.assert_array_equal(D_t, (a[:, None, :] != b[None, :, :]).sum(-1))


def _tied_sets(seed):
    """Descriptor sets built to tie: repeated rows in both sets (equal
    distances in rows and columns), and copies a few bits apart."""
    rng = np.random.default_rng(seed)
    base = _signs(rng, 6)
    s1 = base[rng.integers(0, 6, 48)].copy()
    s2 = base[rng.integers(0, 6, 40)].copy()
    for s in (s1, s2):
        flip = rng.uniform(size=s.shape) < 0.02
        s[flip & (rng.uniform(size=s.shape) < 0.5)] *= -1
    s2[::5] = s1[:8]  # exact duplicates across the sets
    return s1, s2, rng.uniform(size=48) > 0.2, rng.uniform(size=40) > 0.2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ratio", [None, 0.9])
@pytest.mark.parametrize("cross_check", [True, False])
def test_match_exact_on_ties(masked, ratio, cross_check):
    s1, s2, v1, v2 = _tied_sets(5)
    D = s1 @ s2.T
    assert (D == D.max(1, keepdims=True)).sum(1).max() > 1  # ties exist
    kw = dict(cross_check=cross_check, max_dist=64.0, ratio=ratio)
    m_j = jmatch.match(jnp.asarray(s1), jnp.asarray(s2),
                       valid1=jnp.asarray(v1) if masked else None,
                       valid2=jnp.asarray(v2) if masked else None, **kw)
    m_t = tmatch.match(torch.from_numpy(s1), torch.from_numpy(s2),
                       valid1=torch.from_numpy(v1) if masked else None,
                       valid2=torch.from_numpy(v2) if masked else None, **kw)
    np.testing.assert_array_equal(m_t.idx.numpy(), np.asarray(m_j.idx))
    np.testing.assert_array_equal(m_t.dist.numpy(), np.asarray(m_j.dist))
    np.testing.assert_array_equal(m_t.valid.numpy(), np.asarray(m_j.valid))
    assert m_t.valid.any()


def test_match_batched_equals_single():
    sets = [_tied_sets(s) for s in (6, 7)]
    stack = lambda i: torch.from_numpy(np.stack([s[i] for s in sets]))
    m_b = tmatch.match(stack(0), stack(1), valid1=stack(2), valid2=stack(3), ratio=0.9)
    for b, (s1, s2, v1, v2) in enumerate(sets):
        m = tmatch.match(*(torch.from_numpy(x) for x in (s1, s2)),
                         valid1=torch.from_numpy(v1), valid2=torch.from_numpy(v2), ratio=0.9)
        for a, s in zip(m_b, m):
            assert torch.equal(a[b], s)


def test_resize_matches_reference():
    rng = np.random.default_rng(2)
    for (H, W), (h, w) in (((160, 200), (133, 167)), ((111, 139), (92, 116))):
        x = rng.uniform(0, 255, (H, W)).astype(np.float32)
        r = np.asarray(jax.image.resize(jnp.asarray(x), (h, w), method="linear"))
        t = timage.resize_linear(torch.from_numpy(x), h, w).numpy()
        np.testing.assert_allclose(t, r, atol=2e-3)


def _reference_levels(img, n_levels=8, s=1.2):
    k = jnp.array([0.25, 0.5, 0.25], img.dtype)
    cur, out = img, [img]
    for _ in range(n_levels - 1):
        nh = max(int(round(cur.shape[0] / s)), 1)
        nw = max(int(round(cur.shape[1] / s)), 1)
        cur = jax.image.resize(jimage._sep_conv3(cur, k, k), (nh, nw), method="linear")
        out.append(cur)
    return out


def test_pyramid_levels_and_keypoints_match_reference():
    f0, f1 = _corridor_frame(160, 200, seed=3)
    lv_j = _reference_levels(jnp.asarray(f0))
    cur, blur = torch.from_numpy(f0), (0.25, 0.5, 0.25)
    for lv in range(1, len(lv_j)):
        H, W = lv_j[lv].shape
        cur = timage.resize_linear(timage._sep_conv3(cur, blur, blur), H, W)
        np.testing.assert_allclose(cur.numpy(), np.asarray(lv_j[lv]), atol=2e-3)

    kp_j, d_j, lev_j = jax.jit(lambda x: jorb.detect_and_describe_pyramid(x, 12.0, 256))(
        jnp.asarray(f0))
    kp_t, d_t, lev_t = torb.detect_and_describe_pyramid(torch.from_numpy(f0), 12.0, 256)
    np.testing.assert_array_equal(lev_t.numpy(), np.asarray(lev_j))
    assert kp_t.xy.shape == kp_j.xy.shape == (239, 2)  # levels 6-7 are under 2 * PATCH
    for lv in np.unique(np.asarray(lev_j)):
        sel = np.asarray(lev_j) == lv
        np.testing.assert_allclose(kp_t.xy.numpy()[sel], np.asarray(kp_j.xy)[sel], atol=1e-4)
        np.testing.assert_array_equal(kp_t.valid.numpy()[sel], np.asarray(kp_j.valid)[sel])
    # One stacked call equals two single-frame calls.
    kp_b, d_b, lev_b = torb.detect_and_describe_pyramid(
        torch.from_numpy(np.stack([f0, f1])), 12.0, 256)
    for b, f in enumerate((f0, f1)):
        kp_s, d_s, _ = torb.detect_and_describe_pyramid(torch.from_numpy(f), 12.0, 256)
        for a, s in zip(kp_b + d_b, kp_s + d_s):
            assert torch.equal(a[b], s)
