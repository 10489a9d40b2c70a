"""Port parity: FAST detection (epivo_tpu_torch vs epivo_tpu).

The score map and its 3x3 NMS only subtract, take min/max and compare, so
the port is held to them bit for bit. On integer-valued images the scores
are integers and tie often; ``detect`` must still give the same keypoints
in the same order (top-k ties go to the lower index in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.frontend import fast as jfast
from epivo_tpu_torch.frontend import fast as tfast


def _int_image(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 96), (127, 255), (200, 300)])
def test_score_map_and_nms_bit_exact(shape):
    img = _int_image(shape, 0)
    ref = jfast.fast_score_map(jnp.asarray(img), 25.0)
    out = tfast.fast_score_map(torch.from_numpy(img), 25.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tfast.nms3(out).numpy(), np.asarray(jfast.nms3(ref)))


def test_score_map_batched_and_flat():
    imgs = np.stack([_int_image((40, 56), s) for s in range(3)])
    out = tfast.fast_score_map(torch.from_numpy(imgs), 20.0)
    for b in range(3):
        np.testing.assert_array_equal(
            out[b].numpy(), tfast.fast_score_map(torch.from_numpy(imgs[b]), 20.0).numpy())
    flat = torch.full((50, 70), 77.0)
    assert float(tfast.nms3(tfast.fast_score_map(flat, 10.0)).max()) == 0.0


@pytest.mark.parametrize("shape,k", [((96, 128), 64), ((256, 320), 256)])
def test_detect_same_keypoints_same_order(shape, k):
    # (96, 128) is below the two-stage threshold (H*W < 65536), (256, 320)
    # above it. Smoothing the integer image keeps integer scores with many ties.
    img = _int_image(shape, 1)
    img = np.round((img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3.0).astype(np.float32)
    kp_j = jfast.detect(jnp.asarray(img), 20.0, k, use_pallas=False)
    kp_t = tfast.detect(torch.from_numpy(img), 20.0, k)
    np.testing.assert_array_equal(kp_t.xy.numpy(), np.asarray(kp_j.xy))
    np.testing.assert_array_equal(kp_t.score.numpy(), np.asarray(kp_j.score))
    np.testing.assert_array_equal(kp_t.valid.numpy(), np.asarray(kp_j.valid))
    scores = kp_t.score[kp_t.valid].numpy()
    assert len(np.unique(scores)) < len(scores), "fixture should contain ties"


@pytest.mark.parametrize("two_stage", [False, True])
def test_top_k_keypoints_ties(two_stage):
    # Scores constant over many pixels: the order is decided by index alone.
    rng = np.random.default_rng(2)
    score = rng.integers(0, 3, (64, 80)).astype(np.float32) * 10
    kp_j = jfast.top_k_keypoints(jnp.asarray(score), 100, two_stage=two_stage)
    kp_t = tfast.top_k_keypoints(torch.from_numpy(score), 100, two_stage=two_stage)
    np.testing.assert_array_equal(kp_t.xy.numpy(), np.asarray(kp_j.xy))
    np.testing.assert_array_equal(kp_t.score.numpy(), np.asarray(kp_j.score))


def test_kernel_switch_on_cpu():
    img = torch.from_numpy(_int_image((32, 48), 3))
    with pytest.raises(ValueError, match="CUDA"):
        tfast.detect(img, 20.0, 16, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfast.fast_score_map_kernel(img, 20.0)
    before = tfast.KERNEL_LAUNCHES
    a = tfast.detect(img, 20.0, 16)
    b = tfast.detect(img, 20.0, 16, use_kernel=False)
    np.testing.assert_array_equal(a.xy.numpy(), b.xy.numpy())
    assert tfast.KERNEL_LAUNCHES == before
