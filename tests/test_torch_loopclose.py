"""Port parity: loop closure's host half, retrieval, control flow and the
runners' loop stage (``epivo_tpu_torch/pipeline/loopclose.py`` against
``epivo_tpu/pipeline/loopclose.py``).

Inputs are made from seeds with numpy and go through both packages:

- ``keyframe_half`` bit-equal (uint8) on random frames of even and odd
  sizes; ``KeyframeStore`` with the same keys, images and stride after
  its budget doubles the stride;
- the host SE(3) exp / log, ``_apply_scale_ramp``, ``spread_drift`` and
  ``implied_drift_rate`` within 1e-12 (both are the same float64 numpy);
- ``retrieval_scores`` on random ±1 signs with masked lanes and a planted
  revisit BIT-EQUAL (the ±1 products are exact in float32, and both take
  the first minimum on ties), with query chunks that split the keyframes
  unevenly, and ``shortlist`` equal;
- ``close_loops`` and ``relocalize`` with ``_describe_batch``,
  ``verify_loop`` and ``measure_scale_drift`` replaced in both packages by
  the same deterministic stubs (keyframe ids read from the images), in
  pose-graph and greedy modes: the same loops (i, j, score, inliers,
  sigma, T_meas) and trajectories within 1e-6;
- ``run_ba_sequence`` and ``run_stereo_ba_sequence`` with
  ``loop.enabled`` on the short rendered sequences: the trajectory equals
  loop off (the twin of the reference's
  ``test_runner_loop_stage_noop_on_short_sequence``: the 60x80 keyframes
  are below the oriented-BRIEF patch, so the stage no-ops), and, with
  ``close_loops`` replaced by a stub that moves the trajectory, equals
  ``_loop_stage`` applied to the loop-off result with the same keyframes.

Imagery (rendered loop-course frames, the reference's samples injected)
is in ``tests/test_torch_loopclose_verify.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from epivo_tpu.pipeline import config as jconfig, loopclose as jlc
from epivo_tpu_torch import convert
from epivo_tpu_torch.datasets import photoreal
from epivo_tpu_torch.pipeline import config as tconfig, loopclose as tlc, runners as trunners
from tests.test_runners_datasets import VO_CFG, make_sequence, make_stereo_sequence

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(376, 1241), (60, 80), (7, 9)])
def test_keyframe_half_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    frame = rng.uniform(-5.0, 260.0, shape).astype(np.float32)
    frame[0, :3] = [0.5, 1.5, 254.5]  # halves that round to even
    a, b = jlc.keyframe_half(frame), tlc.keyframe_half(frame)
    assert a.dtype == b.dtype == np.uint8
    assert np.array_equal(a, b)


def test_keyframe_store_same_keys_after_budget_doubles():
    rng = np.random.default_rng(1)
    frames = [rng.uniform(0, 255, (12, 10)).astype(np.float32) for _ in range(70)]
    ref, port = jlc.KeyframeStore(2, budget=16), tlc.KeyframeStore(2, budget=16)
    for idx, f in enumerate(frames):
        ref.offer(idx, f)
        port.offer(idx, f)
        assert sorted(ref.frames) == sorted(port.frames) and ref.stride == port.stride
    assert port.stride == 16 and len(port) <= 16  # doubled three times
    for k in ref.frames:
        assert np.array_equal(ref.frames[k], port.frames[k])
        assert np.array_equal(ref.get(k), port.get(k))
    assert bool(port) and not bool(tlc.KeyframeStore(8))


def _chain(F=60, seed=1):
    """A smooth float64 camera-to-world chain (forward motion with small
    random rotations)."""
    rng = np.random.default_rng(seed)
    T, out = np.eye(4), [np.eye(4)]
    for _ in range(F - 1):
        xi = np.concatenate([[0.1, 0.02, 0.9] + rng.normal(0, 0.05, 3),
                             rng.normal(0, 0.02, 3)])
        T = T @ tlc.se3_exp_np(xi)
        out.append(T.copy())
    return np.stack(out)


def test_host_se3_and_drift_spread_match():
    rng = np.random.default_rng(2)
    for k in range(40):
        xi = rng.normal(0, 0.7, 6)
        if k % 5 == 0:
            xi[3:] *= 1e-13  # the small-angle branches
        a, b = jlc.se3_exp_np(xi), tlc.se3_exp_np(xi)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tlc.se3_log_np(a), jlc.se3_log_np(a), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tlc._so3_exp_np(xi[3:]), jlc._so3_exp_np(xi[3:]),
                                   rtol=0, atol=1e-12)
    traj = _chain()
    T_meas = np.linalg.inv(np.linalg.inv(traj[3]) @ traj[50]) @ tlc.se3_exp_np(
        np.array([0.3, -0.1, 0.4, 0.01, 0.03, -0.02]))
    for sigma in (1.0, 1.37, 0.8):
        np.testing.assert_allclose(tlc._apply_scale_ramp(traj, 3, 50, sigma),
                                   jlc._apply_scale_ramp(traj, 3, 50, sigma),
                                   rtol=0, atol=1e-12)
        out = tlc.spread_drift(traj, 3, 50, T_meas, sigma=sigma)
        np.testing.assert_allclose(out, jlc.spread_drift(traj, 3, 50, T_meas, sigma=sigma),
                                   rtol=0, atol=1e-12)
        # Endpoint-exact closure.
        np.testing.assert_allclose(np.linalg.inv(out[3]) @ out[50], np.linalg.inv(T_meas),
                                   atol=1e-9)
    for i, j in ((3, 50), (10, 40), (0, 59)):
        assert tlc.implied_drift_rate(traj, i, j, T_meas) == pytest.approx(
            jlc.implied_drift_rate(traj, i, j, T_meas), abs=1e-12)


def _signs(seed, N=7, M=48):
    """Random ±1 signs [N, M, 256] with keyframe 5 revisiting keyframe 1
    (5 % of its bits flipped) and masked lanes, among them one keyframe
    with no valid lane."""
    rng = np.random.default_rng(seed)
    signs = (rng.integers(0, 2, (N, M, 256)) * 2 - 1).astype(np.float32)
    flips = rng.random((M, 256)) < 0.05
    signs[5] = np.where(flips, -signs[1], signs[1])
    valid = rng.random((N, M)) > 0.2
    valid[3] = False
    return signs, valid


@pytest.mark.parametrize("chunk", [None, 1, 3, 7])
def test_retrieval_scores_bit_equal(monkeypatch, chunk):
    signs, valid = _signs(0)
    ref = np.asarray(jlc.retrieval_scores(signs, valid, 64.0))
    if chunk is not None:  # queries per chunk (3: chunks of 3, 3 and 1)
        monkeypatch.setattr(tlc, "_chunk_size", lambda N, M: chunk)
    port = tlc.retrieval_scores(torch.from_numpy(signs), torch.from_numpy(valid), 64.0)
    assert port.shape == (7, 7)
    assert np.array_equal(port.numpy(), ref)
    assert ref[5, 1] > 0.5 * 48 and ref[3].max() == 0  # the planted revisit; no lanes
    kf_idx = [0, 40, 80, 120, 160, 200, 240]
    for lcfg in (jconfig.LoopConfig(min_gap=30, min_matches=5),
                 jconfig.LoopConfig(min_gap=150, min_matches=2)):
        tcfg = tconfig.LoopConfig(**dataclasses.asdict(lcfg))
        for per_query in (1, 3):
            assert (tlc.shortlist(port.numpy(), kf_idx, tcfg, per_query)
                    == jlc.shortlist(ref, kf_idx, lcfg, per_query))


def test_retrieval_chunk_size_bounds_table():
    assert tlc._chunk_size(30, 512) == 30
    assert tlc._chunk_size(512, 512) == 2  # 2 x 512 x 512 x 512 x 4 B = 1 GiB
    assert tlc._chunk_size(2000, 512) == 1


# ---------------------------------------------------------------------------
# close_loops / relocalize control flow on deterministic stubs.

KF = 64  # keyframe side: at least 2 * PATCH, so the size guard passes


def _kf_image(idx: int) -> np.ndarray:
    img = np.zeros((KF, KF), np.float32)
    img[0, 0], img[0, 1] = idx % 256, idx // 256
    return img


def _ids(imgs) -> np.ndarray:
    a = np.asarray(imgs)
    return (a[..., 0, 0] + 256 * a[..., 0, 1]).astype(np.int64)


def _place(f: int) -> int:
    """The place frame f sees: the closing straight of the loop course
    (frames >= 200) revisits the start; frame 130's view is an alias of
    frame 24's."""
    return f - 200 if f >= 200 else (24 if f == 130 else f)


def _describe_stub(imgs, cfg, fast_threshold):
    rng = np.random.default_rng(0)
    base = (rng.integers(0, 2, (300, 64, 256)) * 2 - 1).astype(np.float32)
    ids = _ids(imgs)
    signs = np.stack([np.where(np.random.default_rng(1000 + f).random((64, 256)) < 0.04,
                               -base[_place(f)], base[_place(f)]) for f in ids])
    valid = np.ones(signs.shape[:2], bool)
    valid[:, 60:] = False
    return signs, valid


def _stub_measurements(gt, zero_baseline_every=3):
    """verify_loop / measure_scale_drift stubs for either package: the loop
    transform from the ground truth (in chain units at i, scale drift
    1.004 per frame), None for some candidates, few inliers for others,
    and the alias (24, 130) verifying at a contradictory place."""

    def verify(img_i, img_j, img_i_next, t_next_norm, vo_cfg, *rest, **kw):
        i, j = int(_ids(img_i)), int(_ids(img_j))
        assert int(_ids(img_i_next)) == i + 1
        if (i + j) % 13 == 5:
            return None
        # The true relation for a revisit; the alias claims coincidence.
        T = np.linalg.inv(np.linalg.inv(gt[i]) @ gt[j if _place(j) == i and j >= 200 else i])
        zb = (j // 4) % zero_baseline_every == 0
        if zb:
            T[:3, 3] = 0.0
        else:
            T[:3, 3] += [0.05 * np.sin(j), 0.0, 0.03 * np.cos(i)]
        n_inl = 20 + (7 * i + 3 * j) % 300
        return jlc.LoopMeasurement(T, n_inl, zb, float("nan") if zb else 1.0 + 1e-3 * j)

    def scale(img_j, img_i, img_j_next, t_next_norm_j, loop_t_chain_i, vo_cfg, *rest, **kw):
        i, j = int(_ids(img_i)), int(_ids(img_j))
        if j % 3 == 0:
            return None
        return float(1.001 ** (j - i) * (1.0 + 0.01 * np.sin(i)))

    return verify, scale


def _course():
    """(gt, drifted chain, keyframes dict) of the loop course with keyframe
    stride 4."""
    gt = photoreal.loop_trajectory()
    drift = tlc.se3_exp_np(np.array([0.0, 0.0015, 0.0, 0.0, 0.0, 0.008]))
    est = gt.copy()
    for k in range(1, len(est)):
        step = np.linalg.inv(gt[k - 1]) @ gt[k]
        step[:3, 3] *= 1.001 ** k
        est[k] = est[k - 1] @ step @ drift
    kf = {k: _kf_image(k) for k in range(len(gt)) if k % 4 in (0, 1)}
    return gt, est, kf


def _configs(**loop):
    lc = dict(enabled=True, keyframe_stride=4, min_gap=60, min_matches=20, min_inliers=40,
              max_loops=4) | loop
    ref = jconfig.BAConfig(loop=jconfig.LoopConfig(**lc))
    return ref, convert.config_from_reference(ref)


def _stub_both(monkeypatch, gt):
    verify, scale = _stub_measurements(gt)
    for mod in (jlc, tlc):
        monkeypatch.setattr(mod, "_describe_batch", _describe_stub)
        monkeypatch.setattr(mod, "verify_loop", verify)
        monkeypatch.setattr(mod, "measure_scale_drift", scale)


def _assert_loops_equal(lt, lj):
    assert [(l.i, l.j, l.score, l.n_inliers) for l in lt] == \
        [(l.i, l.j, l.score, l.n_inliers) for l in lj]
    for a, b in zip(lt, lj):
        assert a.sigma == pytest.approx(b.sigma, rel=1e-12)
        np.testing.assert_allclose(a.T_meas, b.T_meas, atol=1e-12)


@pytest.mark.parametrize("mode", ["pose_graph", "greedy", "greedy_se3"])
def test_close_loops_control_flow_matches(monkeypatch, mode):
    gt, est, kf = _course()
    _stub_both(monkeypatch, gt)
    ref_cfg, port_cfg = _configs(pose_graph=mode == "pose_graph", sim3=mode != "greedy_se3")
    vo_half = VO_CFG  # unused by the stubs
    traj_j, loops_j = jlc.close_loops(est, kf, ref_cfg, vo_half, seed=0)
    stats = {}
    traj_t, loops_t = tlc.close_loops(est, kf, port_cfg, convert.config_from_reference(vo_half),
                                      seed=0, device="cpu", stats=stats)
    # The joint branch has something to join; greedy keeps one per span.
    assert len(loops_j) >= (2 if mode == "pose_graph" else 1), loops_j
    _assert_loops_equal(loops_t, loops_j)
    assert traj_t.dtype == np.float32 and traj_t.shape == est.shape
    np.testing.assert_allclose(traj_t, np.asarray(traj_j), rtol=0, atol=1e-6)
    assert not np.allclose(traj_t, est.astype(np.float32), atol=1e-3)  # it corrected
    assert stats["keyframes"] == 59 and stats["loops_applied"] == len(loops_t)
    assert stats["candidates"] >= stats["verifications"] >= len(loops_t)
    assert (stats["pose_graph"] is not None) == (mode == "pose_graph")


def test_close_loops_no_op_guards():
    _, est, _ = _course()
    ref_cfg, port_cfg = _configs()
    small = {k: np.zeros((40, 40), np.float32) for k in (0, 1, 4, 5, 8, 9)}
    few = {k: _kf_image(k) for k in (0, 1, 4, 5)}
    for kf in (small, few):
        traj_t, loops_t = tlc.close_loops(est, kf, port_cfg, None, device="cpu")
        traj_j, loops_j = jlc.close_loops(est, kf, ref_cfg, None)
        assert loops_t == [] == loops_j and traj_t is est and traj_j is est


def test_relocalize_control_flow_matches(monkeypatch):
    gt, _, kf = _course()
    _stub_both(monkeypatch, gt)
    c = len(gt) - 30
    est = gt.copy()
    wrong = np.eye(4)
    wrong[:3, 3] = [6.0, 0.5, -9.0]  # teleported anchor
    est[c:] = wrong[None] @ gt[c:]
    ref_cfg, port_cfg = _configs(min_gap=0)
    traj_j, lp_j = jlc.relocalize(est, kf, ref_cfg, VO_CFG, collapse_idx=c, seed=0)
    vo_half = convert.config_from_reference(VO_CFG)  # read for its FAST threshold
    traj_t, lp_t = tlc.relocalize(est, kf, port_cfg, vo_half, collapse_idx=c, seed=0,
                                  device="cpu")
    assert lp_j is not None and lp_j.j > c
    _assert_loops_equal([lp_t], [lp_j])
    np.testing.assert_allclose(traj_t, np.asarray(traj_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(traj_t[:c], gt[:c], atol=1e-6)  # prefix untouched
    # No post-collapse keyframe: nothing to re-anchor.
    out, lp = tlc.relocalize(est, kf, port_cfg, vo_half, collapse_idx=len(gt), device="cpu")
    assert lp is None and out is est


# ---------------------------------------------------------------------------
# The runners' loop stage.

LOOP_ON = tconfig.LoopConfig(enabled=True, keyframe_stride=2, min_gap=100)


def _ba_config(loop):
    return tconfig.BAConfig(camera=convert.config_from_reference(VO_CFG).camera,
                            frontend=convert.config_from_reference(VO_CFG).frontend,
                            ransac=convert.config_from_reference(VO_CFG).ransac,
                            lm=tconfig.LMConfig(n_points=32, revert_r_norm=1e-2), loop=loop)


def _moving_stub(seen: list):
    """A close_loops stand-in that records what the stage hands it and
    moves the trajectory by an amount that depends on every input."""

    def stub(traj, keyframes, config, vo_cfg_half, seed=0, mlog=None, device=None,
             stats=None):
        keys = sorted(keyframes.frames)
        seen.append(dict(keys=keys, stride=keyframes.stride, shape=keyframes.frames[0].shape,
                         cam=vo_cfg_half.camera, pyramid=vo_cfg_half.frontend.orb_pyramid,
                         kp=vo_cfg_half.frontend.max_keypoints, seed=seed))
        out = np.asarray(traj, np.float64).copy()
        out[:, :3, 3] += 0.01 * (1 + seed) * sum(float(keyframes.frames[k].mean()) for k in keys)
        stats["called"] = True
        return out.astype(np.float32), [tlc.Loop(0, len(traj) - 1, np.eye(4), 50, 60)]

    return stub


def test_run_ba_sequence_loop_stage(monkeypatch):
    frames, gt = make_sequence(F=6)
    frames = [np.asarray(f, np.float32) for f in frames]
    # Twin of the reference's no-op test: the same trajectory as loop off.
    off = trunners.run_ba_sequence(list(frames), _ba_config(tconfig.LoopConfig()),
                                   gt_poses=gt, device="cpu")
    on = trunners.run_ba_sequence(list(frames), _ba_config(LOOP_ON), gt_poses=gt,
                                  device="cpu")
    np.testing.assert_allclose(on.trajectory, off.trajectory, atol=1e-6)
    # The tee sees the frames the extraction reads: with the ground truth
    # no window needs frame 5, so keyframes 0 and 2 have their successor.
    assert on.loops == () and on.stats["loop"]["keyframes"] == 2
    # With a stage that moves the trajectory: loop on == the stage applied
    # to loop off with the keyframes of the same frames (no ground truth:
    # the scale graph's skip pairs read every frame, as on the loop
    # courses of ``tools/photoreal_loop.py``).
    seen: list = []
    off = trunners.run_ba_sequence(list(frames), _ba_config(tconfig.LoopConfig()),
                                   device="cpu")
    monkeypatch.setattr(tlc, "close_loops", _moving_stub(seen))
    on = trunners.run_ba_sequence(iter(frames), _ba_config(LOOP_ON), n_frames=6,
                                  device="cpu")
    store = tlc.KeyframeStore(2)
    for k, f in enumerate(frames):
        store.offer(k, f)
    traj, loops = trunners._loop_stage(off.trajectory, store, _ba_config(LOOP_ON), 0, None,
                                       device="cpu")
    np.testing.assert_array_equal(on.trajectory, traj)
    assert not np.allclose(on.trajectory, off.trajectory, atol=1e-3)
    assert len(on.loops) == len(loops) == 1 and on.stats["loop"]["called"]
    assert seen[0] == seen[1] and seen[0]["keys"] == list(range(6))
    assert seen[0]["shape"] == (60, 80) and seen[0]["pyramid"] and seen[0]["kp"] == 512
    assert (seen[0]["cam"].fx, seen[0]["cam"].cx, seen[0]["cam"].width) == (100.0, 40.0, 80)


def test_run_stereo_ba_sequence_loop_stage(monkeypatch):
    L, R, gt, T_rig = make_stereo_sequence(F=4)
    off = trunners.run_stereo_ba_sequence(L, R, _ba_config(tconfig.LoopConfig()), T_rig=T_rig,
                                          gt_poses=gt, device="cpu")
    on = trunners.run_stereo_ba_sequence(L, R, _ba_config(LOOP_ON), T_rig=T_rig, gt_poses=gt,
                                         device="cpu")
    np.testing.assert_allclose(on.trajectory, off.trajectory, atol=1e-6)
    assert on.loops == () and on.stats["loop"]["loops_applied"] == 0
    seen: list = []
    monkeypatch.setattr(tlc, "close_loops", _moving_stub(seen))
    on = trunners.run_stereo_ba_sequence(L, R, _ba_config(LOOP_ON), T_rig=T_rig, gt_poses=gt,
                                         device="cpu")
    store = tlc.KeyframeStore(2)
    for k, f in enumerate(L[:3]):  # the left frames the windows read, indexed by frame
        store.offer(k, f)
    traj, _ = trunners._loop_stage(off.trajectory, store, _ba_config(LOOP_ON), 0, None,
                                   device="cpu")
    np.testing.assert_array_equal(on.trajectory, traj)
    assert seen[0]["keys"] == list(range(3)) and len(on.loops) == 1
    for k in range(3):
        assert np.array_equal(store.frames[k], tlc.keyframe_half(L[k]))
