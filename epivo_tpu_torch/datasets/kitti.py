"""KITTI odometry dataset adapter (port of ``epivo_tpu/datasets/kitti.py``,
numpy, copied with the port's ``Pinhole``).

Replaces the reference's hardcoded ingestion (`kitti_E.cpp:37-65`:
hardwired paths, printf-formatted filenames, space-separated pose CSV;
`kitti_ba.cpp:1072-1102`: hardwired intrinsics and stereo projection
matrices). Host-side IO only — images decode on host and upload to the
device as float32 batches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from epivo_tpu_torch.geometry.camera import Pinhole


@dataclasses.dataclass(frozen=True)
class KittiSequence:
    root: str  # dataset root containing sequences/ and poses/
    seq: str  # e.g. "00"
    cam: str = "image_0"  # grayscale left; image_1 = grayscale right

    @property
    def image_dir(self) -> str:
        return os.path.join(self.root, "sequences", self.seq, self.cam)

    @property
    def calib_file(self) -> str:
        return os.path.join(self.root, "sequences", self.seq, "calib.txt")

    @property
    def poses_file(self) -> str:
        return os.path.join(self.root, "poses", f"{self.seq}.txt")

    def exists(self) -> bool:
        return os.path.isdir(self.image_dir)

    def image_path(self, i: int) -> str:
        return os.path.join(self.image_dir, f"{i:06d}.png")

    def n_frames(self) -> int:
        n = 0
        while os.path.exists(self.image_path(n)):
            n += 1
        return n

    def load_calib(self) -> dict:
        """Parse calib.txt -> {name: [3, 4] projection matrix}."""
        out = {}
        with open(self.calib_file) as f:
            for line in f:
                if ":" not in line:
                    continue
                name, vals = line.split(":", 1)
                arr = np.fromstring(vals, sep=" ")
                if arr.size == 12:
                    out[name.strip()] = arr.reshape(3, 4)
        return out

    def intrinsics(self) -> Pinhole:
        """Left-gray intrinsics from P0 (falls back to the seq-00 constants
        the reference hardcodes, `kitti_E.cpp:38-40`)."""
        try:
            P0 = self.load_calib()["P0"]
            return Pinhole(fx=float(P0[0, 0]), fy=float(P0[1, 1]),
                           cx=float(P0[0, 2]), cy=float(P0[1, 2]))
        except (OSError, KeyError):
            from epivo_tpu_torch.geometry.camera import KITTI_00

            return KITTI_00

    def stereo_baseline_T(self) -> np.ndarray:
        """Left->right rig transform from the projection matrices
        (the reference computes T_LR = P_L^-1 P_R at `kitti_ba.cpp:1081-1094`;
        for rectified KITTI this is a pure x-translation of baseline*fx)."""
        calib = self.load_calib()
        P0, P1 = calib["P0"], calib["P1"]
        # P = K [R | t]; rectified: R = I, t_x = -fx * baseline
        K = P0[:3, :3]
        t0 = np.linalg.solve(K, P0[:, 3])
        t1 = np.linalg.solve(K, P1[:, 3])
        T = np.eye(4)
        T[:3, 3] = t1 - t0  # left-cam coords of right cam origin (negated dir)
        return T

    def load_poses(self) -> np.ndarray:
        """GT poses [F, 4, 4] (KITTI 12-value rows; ref loader
        `kitti_E.cpp:18-34,203-215`)."""
        raw = np.loadtxt(self.poses_file).reshape(-1, 3, 4)
        F = raw.shape[0]
        out = np.tile(np.eye(4), (F, 1, 1))
        out[:, :3, :] = raw
        return out

    def load_image(self, i: int) -> np.ndarray:
        """[H, W] float32 grayscale in [0, 255]."""
        from PIL import Image

        with Image.open(self.image_path(i)) as im:
            return np.asarray(im.convert("L"), dtype=np.float32)

    def frames(self, start: int = 0, stop: int | None = None) -> Iterator[np.ndarray]:
        i = start
        while (stop is None or i < stop) and os.path.exists(self.image_path(i)):
            yield self.load_image(i)
            i += 1


def gt_step_scales(poses: np.ndarray) -> np.ndarray:
    """Per-frame GT translation magnitudes ||t_i->i+1|| — the scale the
    reference injects into monocular VO (`kitti_E.cpp:218-223`)."""
    rel = np.linalg.inv(poses[:-1]) @ poses[1:]
    return np.linalg.norm(rel[:, :3, 3], axis=-1)
