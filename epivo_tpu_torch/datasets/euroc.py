"""EuRoC MAV dataset adapter: CSV ingestion, quaternion GT, undistortion
(port of ``epivo_tpu/datasets/euroc.py``, numpy, copied with the port's
``Pinhole``).

Replaces the reference's EuRoC path (`euroc.cpp:21-84,87-175,229-252`):
comma-separated CSV with header, image timestamp list, quaternion-to-R, the
body-camera extrinsic, radial-tangential undistortion via precomputed remap
grids, and GT association by nearest timestamp (the reference uses a
hand-tuned start-index heuristic and fixed tolerance at `euroc.cpp:229-252`;
we do exact nearest-neighbor association on timestamps, strictly stronger).

The undistort/rectify map is computed once on host (numpy) and applied per
frame; map application is a dense separable-friendly warp done on host
alongside PNG decode (device code sees clean pinhole images, keeping the
device pipeline shape-static and gather-free).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from epivo_tpu_torch.geometry.camera import Pinhole

# EuRoC cam0 calibration (ref `euroc.cpp:92-101`).
EUROC_CAM0_K = np.array(
    [[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]]
)
EUROC_CAM0_DIST = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
# Body->cam0 extrinsic T_BS^-1 (ref T_DC, `euroc.cpp:119-124`).
EUROC_T_BS = np.array(
    [
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ]
)
# EuRoC cam1 calibration + extrinsic (mav0/cam1/sensor.yaml; the reference
# only ever ingests cam0 — full stereo rectification is a parity extension,
# matching the rectify-maps role of `euroc.cpp:104-111`).
EUROC_CAM1_K = np.array(
    [[457.587, 0.0, 379.999], [0.0, 456.134, 255.238], [0.0, 0.0, 1.0]]
)
EUROC_CAM1_DIST = np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05])
EUROC_T_BS_CAM1 = np.array(
    [
        [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
        [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
        [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
        [0.0, 0.0, 0.0, 1.0],
    ]
)


def quat_to_R(qw, qx, qy, qz) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix (ref `euroc.cpp:69-84`)."""
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


def undistort_map(K: np.ndarray, dist: np.ndarray, shape,
                  K_new: np.ndarray | None = None,
                  R: np.ndarray | None = None):
    """Remap grids (map_x, map_y) for radial-tangential undistortion with an
    optional rectifying rotation.

    Equivalent to cv::initUndistortRectifyMap (ref `euroc.cpp:104-111`):
    for each destination pixel, the source position in the distorted image.
    ``R`` maps rays of the NEW (rectified) camera frame back into the
    ORIGINAL camera frame (pass Rrect.T from :func:`stereo_rectify`).
    """
    H, W = shape
    K_new = K if K_new is None else K_new
    k1, k2, p1, p2 = dist[:4]
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64),
                         np.arange(W, dtype=np.float64), indexing="ij")
    # normalized coords in the new (undistorted/rectified) camera
    x = (xx - K_new[0, 2]) / K_new[0, 0]
    y = (yy - K_new[1, 2]) / K_new[1, 1]
    if R is not None:
        X = R[0, 0] * x + R[0, 1] * y + R[0, 2]
        Y = R[1, 0] * x + R[1, 1] * y + R[1, 2]
        Z = R[2, 0] * x + R[2, 1] * y + R[2, 2]
        x = X / Z
        y = Y / Z
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_x = K[0, 0] * x_d + K[0, 2]
    map_y = K[1, 1] * y_d + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """Bilinear remap (host-side, cv::remap equivalent, `euroc.cpp:170-175`)."""
    H, W = img.shape
    x0 = np.clip(np.floor(map_x).astype(np.int64), 0, W - 2)
    y0 = np.clip(np.floor(map_y).astype(np.int64), 0, H - 2)
    fx = np.clip(map_x - x0, 0.0, 1.0)
    fy = np.clip(map_y - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    out = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    oob = (map_x < 0) | (map_x > W - 1) | (map_y < 0) | (map_y > H - 1)
    out[oob] = 0.0
    return out.astype(np.float32)


def _so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (host-side, numpy)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * th / (2.0 * np.sin(th))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def stereo_rectify(K0, dist0, T_BS0, K1, dist1, T_BS1, shape,
                   K_new: np.ndarray | None = None):
    """Full stereo rectification from the two camera extrinsics.

    Bouguet's construction, implemented from the math (the reference builds
    equivalent maps with cv::initUndistortRectifyMap, `euroc.cpp:104-111`,
    but only for cam0): split the inter-camera rotation evenly between the
    two cameras, then rotate both so the baseline lies exactly along -x
    (matching the KITTI rig convention used by the stereo BA runner:
    T_rig[0,3] = -baseline, X_R = X_L - b).

    Args:
      K0/dist0/T_BS0: cam0 intrinsics, radtan distortion, sensor->body.
      K1/dist1/T_BS1: same for cam1.
      shape: (H, W) image shape.
      K_new: target pinhole (default: cam0's K).

    Returns:
      (maps0, maps1, K_new, T_rig, Rrect0): per-camera (map_x, map_y)
      remap grids, the shared rectified intrinsics, the rectified L->R rig
      transform (pure -x baseline), and cam0's rectifying rotation (for
      mapping GT poses into the rectified frame).
    """
    K_new = np.asarray(K0, np.float64) if K_new is None else K_new
    # cam0 -> cam1: p_C1 = T_rel p_C0, T_rel = T_BS1^-1 @ T_BS0.
    T_rel = np.linalg.inv(T_BS1) @ T_BS0
    R_rel, t_rel = T_rel[:3, :3], T_rel[:3, 3]

    # Split the relative rotation: cam0 rotated forward by half, cam1
    # backward by half — R_half^2 = R_rel.
    R_half = _so3_exp(_so3_log(R_rel) / 2.0)
    R0_pre = R_half          # applied to cam0 rays
    R1_pre = np.linalg.inv(R_half)  # applied to cam1 rays
    t_mid = R1_pre @ t_rel   # baseline expressed mid-frame

    # Row-alignment rotation: new x-axis along -t (so the rectified rig
    # translation is (-b, 0, 0)), y chosen orthogonal near the old y.
    e1 = -t_mid / np.linalg.norm(t_mid)
    k = np.array([0.0, 0.0, 1.0])
    e2 = np.cross(k, e1)
    e2 = e2 / np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    R_row = np.stack([e1, e2, e3])

    Rrect0 = R_row @ R0_pre
    Rrect1 = R_row @ R1_pre
    b = float(np.linalg.norm(t_mid))
    T_rig = np.eye(4)
    T_rig[0, 3] = -b

    maps0 = undistort_map(K0, dist0, shape, K_new=K_new, R=Rrect0.T)
    maps1 = undistort_map(K1, dist1, shape, K_new=K_new, R=Rrect1.T)
    return maps0, maps1, K_new, T_rig, Rrect0


@dataclasses.dataclass(frozen=True)
class EurocSequence:
    root: str  # e.g. ".../V2_01_easy" containing mav0/
    cam: str = "cam0"

    @property
    def cam_dir(self) -> str:
        return os.path.join(self.root, "mav0", self.cam, "data")

    @property
    def cam_csv(self) -> str:
        return os.path.join(self.root, "mav0", self.cam, "data.csv")

    @property
    def gt_csv(self) -> str:
        return os.path.join(
            self.root, "mav0", "state_groundtruth_estimate0", "data.csv"
        )

    def exists(self) -> bool:
        return os.path.isdir(self.cam_dir)

    def image_list(self):
        """[(timestamp_ns, filename)] from the cam data.csv
        (ref `load_fns`, `euroc.cpp:45-66`)."""
        out = []
        with open(self.cam_csv) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.strip().split(",")
                if len(parts) >= 2:
                    out.append((int(parts[0]), parts[1]))
        return out

    def load_gt(self):
        """(timestamps [N], poses [N, 4, 4] world-from-body) from the GT CSV
        (ref `load_csv` + quaternion conversion, `euroc.cpp:21-42,69-84`)."""
        ts, poses = [], []
        with open(self.gt_csv) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = np.fromstring(line, sep=",")
                if v.size < 8:
                    continue
                T = np.eye(4)
                T[:3, 3] = v[1:4]
                T[:3, :3] = quat_to_R(v[4], v[5], v[6], v[7])
                ts.append(int(v[0]))
                poses.append(T)
        return np.asarray(ts), np.stack(poses)

    def load_gt_cam0(self):
        """World-from-cam0 GT poses: T_WB @ T_BS (ref applies T_DC at
        `euroc.cpp:259-263`)."""
        ts, T_WB = self.load_gt()
        return ts, T_WB @ EUROC_T_BS[None]

    def load_image(self, fname: str) -> np.ndarray:
        from PIL import Image

        with Image.open(os.path.join(self.cam_dir, fname)) as im:
            return np.asarray(im.convert("L"), dtype=np.float32)

    def undistorted_frames(self, start: int = 0, stop: int | None = None):
        """Yield (timestamp, undistorted image) pairs."""
        imgs = self.image_list()[start:stop]
        maps = None
        for ts, fn in imgs:
            img = self.load_image(fn)
            if maps is None:
                maps = undistort_map(EUROC_CAM0_K, EUROC_CAM0_DIST, img.shape)
            yield ts, remap(img, *maps)

    def stereo_rectification(self, shape):
        """Rectify maps + rectified rig for this sequence's cam0/cam1."""
        return stereo_rectify(EUROC_CAM0_K, EUROC_CAM0_DIST, EUROC_T_BS,
                              EUROC_CAM1_K, EUROC_CAM1_DIST, EUROC_T_BS_CAM1,
                              shape)

    def stereo_timestamps(self, start: int = 0, stop: int | None = None):
        """Timestamps of the matched stereo pairs that
        :meth:`rectified_stereo_frames` will yield (no image decode)."""
        cam1 = dataclasses.replace(self, cam="cam1")
        ts1 = {ts for ts, _ in cam1.image_list()}
        picked = [ts for ts, _ in self.image_list() if ts in ts1]
        return picked[start:stop]

    def rectified_stereo_frames(self, start: int = 0, stop: int | None = None):
        """Yield (timestamp, rectified_cam0, rectified_cam1) triples for
        timestamp-matched stereo pairs (EuRoC cameras are hardware-synced;
        pairs are matched exactly by timestamp). The full-rectification
        counterpart of the reference's cam0-only maps (`euroc.cpp:104-111`).
        """
        cam1 = dataclasses.replace(self, cam="cam1")
        l0 = self.image_list()
        ts1_map = dict(cam1.image_list())
        picked = [(ts, fn, ts1_map[ts]) for ts, fn in l0 if ts in ts1_map]
        picked = picked[start:stop]
        maps = None
        for ts, fn0, fn1 in picked:
            img0 = self.load_image(fn0)
            img1 = cam1.load_image(fn1)
            if maps is None:
                m0, m1, _, _, _ = self.stereo_rectification(img0.shape)
                maps = (m0, m1)
            yield ts, remap(img0, *maps[0]), remap(img1, *maps[1])


def associate(ts_query: np.ndarray, ts_ref: np.ndarray, tol_ns: int = 5_000_000):
    """Nearest-timestamp association: for each query, index into ref (or -1).

    Replaces the reference's start-offset heuristic `9.25*(i-28)` and fixed
    tolerance (`euroc.cpp:229-252`) with exact nearest-neighbor association.
    """
    idx = np.searchsorted(ts_ref, ts_query)
    idx = np.clip(idx, 1, len(ts_ref) - 1)
    left = ts_ref[idx - 1]
    right = ts_ref[idx]
    choose_left = (ts_query - left) < (right - ts_query)
    best = np.where(choose_left, idx - 1, idx)
    dt = np.abs(ts_ref[best] - ts_query)
    return np.where(dt <= tol_ns, best, -1)
