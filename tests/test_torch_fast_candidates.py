"""Port parity: the two-stage keypoint budget split into its plain first
stage (``block_candidates``) and second stage
(``keypoints_from_candidates``), against the reference's
``top_k_keypoints(..., two_stage=True)``.

Everything here is exact: the first stage only compares and masks, and the
second is a stable sort, so keypoints, scores and validity are compared bit
for bit. Smoothed integer images give integer scores with many ties, and
the ragged shape (263, 301) gives blocks that stick out of the image.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.frontend import fast as jfast
from epivo_tpu_torch.frontend import fast as tfast


def _smoothed_int_image(shape, seed):
    img = np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)
    return np.round((img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3.0).astype(
        np.float32)


def _nms_map(img, threshold=20.0):
    """The reference's NMS'd score map, as numpy."""
    return np.asarray(jfast.nms3(jfast.fast_score_map(jnp.asarray(img), threshold)))


def _n_candidates(shape):
    H, W = shape
    return (-(-H // 16)) * (-(-W // 16)) * 8


def _assert_same_keypoints(kp_t, kp_j):
    np.testing.assert_array_equal(kp_t.xy.numpy(), np.asarray(kp_j.xy))
    np.testing.assert_array_equal(kp_t.score.numpy(), np.asarray(kp_j.score))
    np.testing.assert_array_equal(kp_t.valid.numpy(), np.asarray(kp_j.valid))


@pytest.mark.parametrize("budget", ["k300", "all"])
@pytest.mark.parametrize("shape", [(256, 320), (263, 301), (257, 289)])
def test_two_stage_matches_reference(shape, budget):
    # With k = nb * 8 the reference's stable top-k returns every candidate
    # in order, so the whole list is compared, zero and out-of-image tail
    # included. At (257, 289) the last block row and column hold one image
    # row or column each, so their zero fill reaches lanes outside the image.
    score = _nms_map(_smoothed_int_image(shape, 4), threshold=50.0)
    k = 300 if budget == "k300" else _n_candidates(shape)
    val, idx = tfast.block_candidates(torch.from_numpy(score))
    assert val.shape == idx.shape == (_n_candidates(shape) // 8, 8)
    assert idx.dtype == torch.int32
    kp_t = tfast.keypoints_from_candidates(val, idx, k, shape[1])
    kp_j = jfast.top_k_keypoints(jnp.asarray(score), k, two_stage=True)
    _assert_same_keypoints(kp_t, kp_j)
    _assert_same_keypoints(tfast.top_k_keypoints(torch.from_numpy(score), k), kp_j)
    scores = kp_t.score[kp_t.valid].numpy()
    assert len(np.unique(scores)) < len(scores), "fixture should contain ties"
    if budget == "all":
        xy = kp_t.xy.numpy()
        assert (kp_t.score.numpy() == 0).any()
        outside = (xy[:, 0] >= shape[1]) | (xy[:, 1] >= shape[0])
        assert outside.any() == (shape == (257, 289))


@pytest.mark.parametrize("shape", [(256, 320), (263, 301)])
def test_flat_image_candidates(shape):
    # No corner anywhere: every candidate is 0, and each block fills its 8
    # slots with its first 8 lanes, as the reference does.
    score = _nms_map(np.full(shape, 90.0, np.float32))
    val, idx = tfast.block_candidates(torch.from_numpy(score))
    assert float(val.abs().max()) == 0.0
    Wp = -(-shape[1] // 16) * 16
    np.testing.assert_array_equal((idx % Wp % 16).numpy(),
                                  np.tile(np.arange(8), (idx.shape[0], 1)))
    assert int((idx // Wp % 16).abs().max()) == 0
    k = _n_candidates(shape)
    kp_t = tfast.keypoints_from_candidates(val, idx, k, shape[1])
    _assert_same_keypoints(kp_t, jfast.top_k_keypoints(jnp.asarray(score), k,
                                                       two_stage=True))


def test_batched_candidates_equal_single_calls():
    shape = (263, 301)
    maps = np.stack([_nms_map(_smoothed_int_image(shape, s)) for s in (5, 6)])
    val, idx = tfast.block_candidates(torch.from_numpy(maps))
    kp = tfast.keypoints_from_candidates(val, idx, 200, shape[1])
    for b in range(2):
        v1, i1 = tfast.block_candidates(torch.from_numpy(maps[b]))
        assert torch.equal(val[b], v1) and torch.equal(idx[b], i1)
        kp1 = tfast.keypoints_from_candidates(v1, i1, 200, shape[1])
        assert torch.equal(kp.xy[b], kp1.xy) and torch.equal(kp.score[b], kp1.score)


def test_detect_ragged_two_stage_matches_reference():
    img = _smoothed_int_image((263, 301), 7)
    kp_j = jfast.detect(jnp.asarray(img), 20.0, 256, use_pallas=False)
    _assert_same_keypoints(tfast.detect(torch.from_numpy(img), 20.0, 256), kp_j)


def test_candidate_kernel_refuses_cpu_and_detect_launches_nothing():
    img = torch.from_numpy(_smoothed_int_image((256, 320), 8))
    with pytest.raises(ValueError, match="CUDA"):
        tfast.fast_candidates_kernel(img, 20.0)
    before = (tfast.CAND_LAUNCHES, tfast.KERNEL_LAUNCHES)
    tfast.detect(img, 20.0, 64)
    assert (tfast.CAND_LAUNCHES, tfast.KERNEL_LAUNCHES) == before
