"""Port parity: the dataset readers (``datasets/kitti.py``,
``datasets/euroc.py``), the synthetic scene generator
(``datasets/synthetic.py``), the artifact export (``viz/export.py``) and
the stereo corridor's renderer (``tools/photoreal_stereo.py``).

Tolerances:

- the KITTI and EuRoC fixtures of ``tests/test_runners_datasets.py`` read
  by both packages: every array equal (images, poses, intrinsics, the
  stereo rig, rectified frames);
- ``associate``, ``quat_to_R``, ``undistort_map``, ``remap`` and
  ``stereo_rectify`` on the same inputs: within 1e-12 (the port's copies
  compute the same float64 expressions);
- ``synthetic`` draws from a ``torch.Generator``, not ``jax.random``, so
  it is held to properties: SE(3) poses (R^T R = I and det R = 1 within
  1e-5 in float32, t_z >= 0, rotations within their bound), the
  perturbation within its bound, every point in front of both cameras
  with its target depth inside ``depth_range`` and its projections exact
  (1e-5), the same seed giving the same scene bit for bit; and
  ``compose_span`` equal to the reference's on the same numpy poses
  (float32, within 1e-5);
- ``viz/export``: the files both packages write are byte-equal, and read
  back within the 9 significant digits written;
- the stereo corridor's renderer: bit-equal to the reference's
  ``corridor_stereo_sequence``, in process and in chunks.
"""

import filecmp
import os
import shutil
from multiprocessing.pool import ThreadPool

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu.datasets import euroc as jeuroc, kitti as jkitti, photoreal as jphotoreal
from epivo_tpu.datasets import synthetic as jsynthetic
from epivo_tpu.viz import export as jexport
from epivo_tpu_torch.datasets import euroc as teuroc, kitti as tkitti, synthetic
from epivo_tpu_torch.geometry.camera import Pinhole
from epivo_tpu_torch.viz import export as texport
from tests.test_runners_datasets import fake_euroc, fake_kitti

# Parallel test workers share the CPU: one intra-op thread each (more
# threads only contend on these small tensors).
torch.set_num_threads(1)


def _same(a, b, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# KITTI and EuRoC readers on the reference tests' fixtures.
# ---------------------------------------------------------------------------


def test_kitti_reader_matches_reference(tmp_path):
    root = fake_kitti(tmp_path)
    seq_t, seq_j = tkitti.KittiSequence(root=root, seq="00"), jkitti.KittiSequence(root=root,
                                                                                   seq="00")
    assert seq_t.exists() and seq_t.n_frames() == seq_j.n_frames() == 4
    intr = seq_t.intrinsics()
    assert isinstance(intr, Pinhole) and intr.fx == pytest.approx(718.856, rel=1e-5)
    assert (intr.fx, intr.fy, intr.cx, intr.cy) == tuple(
        getattr(seq_j.intrinsics(), k) for k in ("fx", "fy", "cx", "cy"))
    for k in range(4):
        a, b = seq_t.load_image(k), seq_j.load_image(k)
        assert a.dtype == np.float32 and a.shape == (37, 61) and np.array_equal(a, b)
    poses = seq_t.load_poses()
    _same(poses, seq_j.load_poses())
    _same(tkitti.gt_step_scales(poses), jkitti.gt_step_scales(poses))
    _same(tkitti.gt_step_scales(poses), 1.5, atol=1e-5)
    T_lr = seq_t.stereo_baseline_T()
    _same(T_lr, seq_j.stereo_baseline_T())
    assert abs(T_lr[0, 3]) == pytest.approx(3.861448e2 / 7.18856e2, rel=1e-4)
    for a, b in zip(seq_t.frames(1, 3), seq_j.frames(1, 3), strict=True):
        assert np.array_equal(a, b)
    # Without calib.txt: the sequence-00 constants, the port's own Pinhole.
    os.remove(seq_t.calib_file)
    assert seq_t.intrinsics().cx == seq_j.intrinsics().cx == pytest.approx(607.1928)
    assert isinstance(seq_t.intrinsics(), Pinhole)


def test_euroc_reader_matches_reference(tmp_path):
    root = fake_euroc(tmp_path)
    cam = os.path.join(root, "mav0", "cam0")
    shutil.copytree(cam, os.path.join(root, "mav0", "cam1"))  # a synced right camera
    seq_t, seq_j = teuroc.EurocSequence(root=root), jeuroc.EurocSequence(root=root)
    assert seq_t.exists() and seq_t.image_list() == seq_j.image_list()
    for a, b in zip(seq_t.load_gt(), seq_j.load_gt()):
        _same(a, b)
    for a, b in zip(seq_t.load_gt_cam0(), seq_j.load_gt_cam0()):
        _same(a, b)
    _same(seq_t.load_gt()[1][2, :3, 3], [0.2, 0.4, 0.1])
    for (ta, a), (tb, b) in zip(seq_t.undistorted_frames(), seq_j.undistorted_frames(),
                                strict=True):
        assert ta == tb and a.shape == (48, 75) and np.array_equal(a, b)
    assert seq_t.stereo_timestamps(1) == seq_j.stereo_timestamps(1)
    got = list(seq_t.rectified_stereo_frames(0, 2))
    for a, b in zip(got, seq_j.rectified_stereo_frames(0, 2), strict=True):
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    assert len(got) == 2


def test_euroc_helpers_match_reference():
    ref = np.array([100, 200, 300, 400], np.int64)
    q = np.array([105, 195, 401, 950], np.int64)
    np.testing.assert_array_equal(teuroc.associate(q, ref, tol_ns=10), [0, 1, 3, -1])
    np.testing.assert_array_equal(teuroc.associate(q, ref, tol_ns=10),
                                  jeuroc.associate(q, ref, tol_ns=10))
    rng = np.random.default_rng(4)
    for qv in rng.normal(size=(6, 4)):
        _same(teuroc.quat_to_R(*qv), jeuroc.quat_to_R(*qv), 1e-12)
    for w in rng.normal(size=(4, 3)) * 0.3:
        _same(teuroc._so3_exp(w), jeuroc._so3_exp(w), 1e-12)
        _same(teuroc._so3_log(teuroc._so3_exp(w)), w, 1e-12)
    shape = (48, 75)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    R = teuroc._so3_exp(np.array([0.01, -0.02, 0.005]))
    for dist, Rr in ((np.zeros(4), None), (teuroc.EUROC_CAM0_DIST, None),
                     (teuroc.EUROC_CAM0_DIST, R)):
        mt = teuroc.undistort_map(teuroc.EUROC_CAM0_K, dist, shape, R=Rr)
        mj = jeuroc.undistort_map(jeuroc.EUROC_CAM0_K, dist, shape, R=Rr)
        for a, b in zip(mt, mj):
            _same(a, b, 1e-12)
        _same(teuroc.remap(img, *mt), jeuroc.remap(img, *mj), 1e-12)
    shape = (120, 160)
    got = teuroc.stereo_rectify(teuroc.EUROC_CAM0_K, teuroc.EUROC_CAM0_DIST, teuroc.EUROC_T_BS,
                                teuroc.EUROC_CAM1_K, teuroc.EUROC_CAM1_DIST,
                                teuroc.EUROC_T_BS_CAM1, shape)
    want = jeuroc.EurocSequence(root="").stereo_rectification(shape)
    for a, b in zip(got[:2], want[:2]):
        _same(a[0], b[0], 1e-12)
        _same(a[1], b[1], 1e-12)
    for a, b in zip(got[2:], want[2:]):
        _same(a, b, 1e-12)
    assert got[3][0, 3] < 0


# ---------------------------------------------------------------------------
# Synthetic scenes on a torch.Generator.
# ---------------------------------------------------------------------------


def _assert_se3(T, max_angle=None):
    R, t = T[..., :3, :3].double(), T[..., :3, 3]
    eye = torch.eye(3, dtype=torch.float64).expand_as(R)
    assert torch.allclose(R.transpose(-1, -2) @ R, eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(R), torch.ones(R.shape[:-2], dtype=torch.float64),
                          atol=1e-5)
    assert torch.equal(T[..., 3, :], torch.tensor([0.0, 0.0, 0.0, 1.0]).expand_as(T[..., 3, :]))
    if max_angle is not None:
        cos = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1)
        assert (torch.arccos(cos) <= np.sqrt(3) * max_angle + 1e-4).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_scene_properties(seed):
    reps = [(0, 0), (0, 1), (1, 2), (2, 0)]
    gen = torch.Generator().manual_seed(seed)
    sc = synthetic.gen_scene_sequence(gen, 64, 3, reps, pixel_noise=0.0)
    assert sc.Ts.shape == sc.T0s.shape == (3, 4, 4) and sc.p.shape == (4, 64, 3)
    _assert_se3(sc.Ts, np.pi / 6)
    _assert_se3(sc.T0s)
    assert (sc.Ts[:, 2, 3] >= 0).all() and (sc.Ts[:, :3, 3].abs() <= 2.0).all()
    # The perturbation is bounded: |T^-1 T0| within the noise limits.
    d = torch.linalg.inv(sc.Ts) @ sc.T0s
    assert (d[:, :3, 3].abs() <= 0.1 + 1e-6).all()
    _assert_se3(d, 0.05)
    for r, (z0, z1) in enumerate(reps):
        T = synthetic.compose_span(sc.Ts, z0, z1)
        X = sc.X[r]
        X_t = X @ T[:3, :3].T + T[:3, 3]
        assert (X[:, 2] > 1e-3).all() and (X_t[:, 2] > 0).all()
        assert ((X_t[:, 2] >= 12.0 - 1e-3) & (X_t[:, 2] <= 40.0 + 1e-3)).all()
        torch.testing.assert_close(sc.p[r], X / X[:, 2:], rtol=0, atol=1e-5)
        torch.testing.assert_close(sc.p_t[r], X_t / X_t[:, 2:], rtol=0, atol=1e-5)
    again = synthetic.gen_scene_sequence(torch.Generator().manual_seed(seed), 64, 3, reps)
    for a, b in zip(sc, again):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    other = synthetic.gen_scene_sequence(torch.Generator().manual_seed(seed + 10), 64, 3, reps)
    assert not torch.equal(other.Ts, sc.Ts)


def test_synthetic_pixel_noise_and_generator_device():
    gen = torch.Generator().manual_seed(5)
    T = synthetic.random_pose(gen)
    X, p, p_t = synthetic.gen_points(gen, 200, T, depth_range=(5.0, 9.0), pixel_noise=1e-3)
    X_t = X @ T[:3, :3].T + T[:3, 3]
    assert ((X_t[:, 2] >= 5.0 - 1e-4) & (X_t[:, 2] <= 9.0 + 1e-4)).all()
    e = torch.cat([p[:, :2] - X[:, :2] / X[:, 2:], p_t[:, :2] - X_t[:, :2] / X_t[:, 2:]])
    assert 5e-4 < float(e.std()) < 2e-3 and torch.equal(p[:, 2], torch.ones(200))
    seq = synthetic.random_sequence(torch.Generator().manual_seed(1), 4, dtype=torch.float64)
    assert seq.dtype == torch.float64 and seq.device.type == "cpu"
    pert = synthetic.perturb_sequence(torch.Generator().manual_seed(1), seq, 0.0, 0.0)
    torch.testing.assert_close(pert, seq, rtol=0, atol=1e-12)


@pytest.mark.parametrize("span", [(0, 0), (0, 3), (1, 2), (3, 0), (2, 1)])
def test_compose_span_matches_reference(span):
    Ts = synthetic.random_sequence(torch.Generator().manual_seed(7), 4)
    got = synthetic.compose_span(Ts, *span)
    want = jsynthetic.compose_span(jnp.asarray(Ts.numpy()), *span)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Artifact export.
# ---------------------------------------------------------------------------


def test_export_files_match_reference(tmp_path):
    rng = np.random.default_rng(2)
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, :3, :] = rng.normal(size=(5, 3, 4))
    cloud = rng.normal(size=(40, 3)) * 10
    limits = np.array([0, 12, 25, 31])
    for name, mod in (("t", texport), ("j", jexport)):
        mod.write_poses(str(tmp_path / f"{name}.pose"), poses)
        mod.write_cloud(str(tmp_path / f"{name}.cld"), cloud, str(tmp_path / f"{name}.lims"),
                        limits)
        mod.write_kitti_format(str(tmp_path / f"{name}.txt"), poses)
    for ext in ("pose", "cld", "lims", "txt"):
        assert filecmp.cmp(tmp_path / f"t.{ext}", tmp_path / f"j.{ext}", shallow=False), ext
    np.testing.assert_allclose(texport.read_poses(str(tmp_path / "t.pose")), poses, rtol=1e-8)
    np.testing.assert_allclose(texport.read_cloud(str(tmp_path / "t.cld")), cloud, rtol=1e-8)
    assert np.array_equal(np.fromfile(tmp_path / "t.lims", sep=" ").astype(int), limits)
    kt = np.loadtxt(tmp_path / "t.txt").reshape(-1, 3, 4)
    np.testing.assert_allclose(kt, poses[:, :3, :], rtol=1e-8)
    texport.plot_trajectories(str(tmp_path / "t.png"), {"est": poses, "pts": poses[:, :3, 3]},
                              cloud=cloud)
    assert (tmp_path / "t.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# The stereo corridor's renderer.
# ---------------------------------------------------------------------------


def test_stereo_corridor_render_matches_reference():
    """``corridor_stereo_sequence`` of the port against the reference's,
    and ``tools/photoreal_stereo.camera_frames`` (in process, and in
    chunks of 2 on a pool) against the sequence, bit for bit."""
    from epivo_tpu_torch.datasets import photoreal
    from epivo_tpu_torch.tools import photoreal_stereo as ps

    h, w, F = 24, 80, 5
    L, R, gt, K, T_rig = photoreal.corridor_stereo_sequence(F, H=h, W=w, seed=ps.FIXTURE_SEED)
    Lj, Rj, gt_j, K_j, T_rig_j = jphotoreal.corridor_stereo_sequence(F, H=h, W=w,
                                                                     seed=ps.FIXTURE_SEED)
    for a, b in ((gt, gt_j), (K, K_j), (T_rig, T_rig_j)):
        assert np.array_equal(a, b)
    L, R = list(L), list(R)
    for a, b in zip(L + R, list(Lj) + list(Rj), strict=True):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    with ThreadPool(2) as pool:
        for right, want in ((False, L), (True, R)):
            for p in (None, pool):
                got = list(ps.camera_frames(gt, K, h, w, right, p, chunk=2))
                for a, b in zip(got, want, strict=True):
                    assert np.array_equal(a, b)
    gt_f, _, _, length = ps.stereo_fixture(F, h, w)
    assert np.array_equal(gt_f, gt)
    s = ps.score_metric(gt_f, gt_f, length)
    assert s["ate_metric_rmse_m"] < 1e-9 and s["step_err_max"] < 1e-12
    assert s["length_ratio"] == pytest.approx(1.0, abs=1e-12)
