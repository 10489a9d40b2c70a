"""Pinhole camera model and coordinate normalization (port of
``epivo_tpu/geometry/camera.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from epivo_tpu_torch._device import constant


@dataclasses.dataclass(frozen=True)
class Pinhole:
    """Pinhole intrinsics. A lens's distortion is a :class:`Distortion`
    beside it (``VOConfig.distortion``)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 0
    height: int = 0

    def K(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return constant(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype, device,
        )

    def K_inv(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return constant(
            [
                [1.0 / self.fx, 0.0, -self.cx / self.fx],
                [0.0, 1.0 / self.fy, -self.cy / self.fy],
                [0.0, 0.0, 1.0],
            ],
            dtype, device,
        )

    @staticmethod
    def from_K(K: np.ndarray, width: int = 0, height: int = 0) -> "Pinhole":
        return Pinhole(
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            width=width, height=height,
        )


@dataclasses.dataclass(frozen=True)
class Distortion:
    """Radial-tangential (plumb bob) lens distortion of a :class:`Pinhole`:
    a normalized point (x, y) at r2 = x^2 + y^2 is seen at
    x (1 + k1 r2 + k2 r2^2) + 2 p1 x y + p2 (r2 + 2 x^2), and likewise in
    y (``datasets/euroc.py::undistort_map``)."""

    k1: float
    k2: float
    p1: float
    p2: float


# KITTI odometry grayscale intrinsics (seq 00-02).
KITTI_00 = Pinhole(fx=718.8560, fy=718.8560, cx=607.1928, cy=185.2157,
                   width=1241, height=376)

# EuRoC MAV cam0 pinhole part.
EUROC_CAM0 = Pinhole(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                     width=752, height=480)
# ... and its lens (``datasets/euroc.py``'s ``EUROC_CAM0_DIST``).
EUROC_CAM0_DIST = Distortion(k1=-0.28340811, k2=0.07395907, p1=0.00019359,
                             p2=1.76187114e-05)


def normalize(pix: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """Pixel [..., 2] or homogeneous [..., 3] -> normalized homogeneous [..., 3]."""
    if pix.shape[-1] == 2:
        pix = torch.cat([pix, torch.ones_like(pix[..., :1])], dim=-1)
    return torch.einsum("ij,...j->...i", K_inv, pix)


def denormalize(p: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Normalized homogeneous [..., 3] -> pixel [..., 2]."""
    q = torch.einsum("ij,...j->...i", K, p)
    return q[..., :2] / q[..., 2:3]
