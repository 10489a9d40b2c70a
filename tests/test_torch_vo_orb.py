"""Port parity: the ORB two-view step (``vo_step_orb``, and
``vo_step_orb_batched`` with B pairs per call).

Inputs: pairs 0->1 and 2->3 of the rendered 160x120 sequence of
``tests/test_runners_datasets.py`` (``make_sequence``) at its ``VO_CFG``
(FAST threshold 15, 128 keypoints, 256 hypotheses, 32 LM points); the
96x128 corridor frames of the KLT tests give no match within Hamming 64.
The reference runs ``vo_step_orb`` (and ``jax.vmap`` of it); the
port gets each lane's reference RANSAC samples, drawn from the reference's
own match mask.

Tolerances, lane by lane: the match masks agree on at least 97 % of the
keypoints and the match counts within 3 (a descriptor bit that flips at a
reference near-tie moves a Hamming distance by one, and distances tie
often); n_inliers within 3; ||R_torch - R_jax||_F and the translation
direction within 2e-3; source keypoints equal; reverted equal. A batched
lane against the port's single ``vo_step_orb`` with the same samples:
bit-equal matches, and poses within the same 2e-3 (the LM runs the same
operations on other shapes, and its rounding moves the pose by ~4e-4).

The fewer-than-8-matches gate on flat frames: identity rotation, the
translation [0.1, 0.1, -0.9] at unit norm, ``reverted`` set, as the
reference's gate gives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu import ransac as jransac
from epivo_tpu.frontend import fast as jfast, match as jmatch, orb as jorb
from epivo_tpu.pipeline import vo as jvo
from epivo_tpu_torch import convert
from epivo_tpu_torch.pipeline import vo as tvo
from tests.test_runners_datasets import VO_CFG, make_sequence
from tests.test_torch_vo_batched import _dir

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)

B = 2


def _pairs():
    """[B, H, W] source and target frames: pairs 0->1 and 2->3."""
    frames, _ = make_sequence(F=4)
    frames = [np.asarray(f, np.float32) for f in frames]
    return np.stack(frames[0::2]), np.stack(frames[1::2])


def _small_config():
    return VO_CFG


def _reference_samples(a, b, keys, cfg):
    """Each lane's sample indices as the reference's vo_step_orb draws
    them: its RANSAC mask is the match mask of the same detect, describe
    and match."""
    fc, rc = cfg.frontend, cfg.ransac

    def one(x, y, k):
        kp0 = jfast.detect(x, fc.fast_threshold, fc.max_keypoints)
        kp1 = jfast.detect(y, fc.fast_threshold, fc.max_keypoints)
        d0 = jorb.describe(x, kp0.xy, kp0.valid)
        d1 = jorb.describe(y, kp1.xy, kp1.valid)
        m = jmatch.match(d0.signs, d1.signs, valid1=kp0.valid, valid2=kp1.valid,
                         max_dist=64.0)
        return jransac._sample_indices(k, rc.hypotheses(), fc.max_keypoints, m.valid)

    return np.asarray(jax.jit(jax.vmap(one))(a, b, keys))


def _assert_close(res_t, res_j, lane):
    pick = lambda x: np.asarray(x)[lane]
    inl_t, inl_j = pick(res_t.inlier_mask), pick(res_j.inlier_mask)
    assert abs(int(pick(res_t.n_tracked)) - int(pick(res_j.n_tracked))) <= 3
    assert abs(int(pick(res_t.n_inliers)) - int(pick(res_j.n_inliers))) <= 3
    assert np.mean(inl_t == inl_j) >= 0.97
    T_t, T_j = pick(res_t.T), pick(res_j.T)
    assert np.linalg.norm(T_t[:3, :3] - T_j[:3, :3]) < 2e-3
    assert np.linalg.norm(_dir(T_t[:3, 3]) - _dir(T_j[:3, 3])) < 2e-3
    np.testing.assert_array_equal(pick(res_t.matches_src), pick(res_j.matches_src))
    assert bool(pick(res_t.reverted)) == bool(pick(res_j.reverted))


@pytest.fixture(scope="module")
def orb_run():
    src, tgt = _pairs()
    cfg = _small_config()
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    a, b = jnp.asarray(src), jnp.asarray(tgt)
    res_j = jax.vmap(lambda x, y, k: jvo.vo_step_orb(x, y, k, cfg))(a, b, keys)
    idx = convert.ransac_samples_from_reference(_reference_samples(a, b, keys, cfg))
    tcfg = convert.config_from_reference(cfg)
    res_t = tvo.vo_step_orb_batched(torch.from_numpy(src), torch.from_numpy(tgt), None,
                                    tcfg, ransac_samples=idx)
    return src, tgt, cfg, keys, tcfg, idx, res_t, res_j


def test_vo_step_orb_batched_matches_reference(orb_run):
    *_, res_t, res_j = orb_run
    assert res_t.T.shape == (B, 4, 4) and res_t.matches_tgt.shape == (B, 128, 2)
    assert res_t.n_tracked.dtype == torch.int32 and res_t.reverted.shape == (B,)
    for lane in range(B):
        assert int(res_j.n_tracked[lane]) >= 8  # the pairs pass the match gate
        _assert_close(res_t, res_j, lane)


def test_vo_step_orb_matches_reference_unbatched(orb_run):
    src, tgt, cfg, keys, tcfg, idx, *_ = orb_run
    res_j = jvo.vo_step_orb(jnp.asarray(src[0]), jnp.asarray(tgt[0]), keys[0], cfg)
    res_t = tvo.vo_step_orb(torch.from_numpy(src[0]), torch.from_numpy(tgt[0]), None,
                            tcfg, ransac_samples=idx[0])
    assert res_t.T.shape == (4, 4) and res_t.n_tracked.shape == ()
    add_lane = lambda r: type(r)(*(np.asarray(f)[None] for f in r))
    _assert_close(add_lane(res_t), add_lane(res_j), 0)


def test_batched_lane_matches_single_orb_step(orb_run):
    src, tgt, _, _, tcfg, idx, res_t, _ = orb_run
    for lane in range(B):
        one = tvo.vo_step_orb(torch.from_numpy(src[lane]), torch.from_numpy(tgt[lane]),
                              None, tcfg, ransac_samples=idx[lane])
        assert torch.equal(one.matches_tgt, res_t.matches_tgt[lane])
        assert torch.equal(one.inlier_mask, res_t.inlier_mask[lane])
        T_1, T_b = one.T.numpy(), res_t.T[lane].numpy()
        assert np.linalg.norm(T_1[:3, :3] - T_b[:3, :3]) < 2e-3
        assert np.linalg.norm(_dir(T_1[:3, 3]) - _dir(T_b[:3, 3])) < 2e-3


def test_match_gate_on_flat_frames():
    cfg = _small_config()
    flat = np.full((B, 120, 160), 90.0, np.float32)
    res_j = jvo.vo_step_orb(jnp.asarray(flat[0]), jnp.asarray(flat[0]),
                            jax.random.PRNGKey(0), cfg)
    res_t = tvo.vo_step_orb_batched(torch.from_numpy(flat), torch.from_numpy(flat),
                                    torch.Generator().manual_seed(0),
                                    convert.config_from_reference(cfg))
    expect = np.eye(4, dtype=np.float32)
    expect[:3, 3] = np.array([0.1, 0.1, -0.9]) / np.linalg.norm([0.1, 0.1, -0.9])
    np.testing.assert_allclose(np.asarray(res_j.T), expect, atol=1e-6)
    assert bool(res_j.reverted) and int(res_j.n_tracked) == 0
    for lane in range(B):
        np.testing.assert_allclose(res_t.T[lane].numpy(), expect, atol=1e-6)
    assert bool(res_t.reverted.all()) and int(res_t.n_tracked.sum()) == 0
    assert not bool(res_t.points_valid.any())
