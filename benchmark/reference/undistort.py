"""Radial-tangential undistortion of raw frames, plain: numpy's
``undistort_map`` and ``remap`` (the EuRoC adapter's host undistortion,
upstream ``euroc.cpp:104-111,170-175``) written in torch with numpy's
float64 arithmetic, in its order.

The map is computed on the CPU, where torch divides by a scalar exactly
(on CUDA it multiplies by the reciprocal), rounded to float32 as numpy
does, and then applied on the frames' device: the floor clipped to [0,
W - 2] and [0, H - 2], the weights in float64 (numpy promotes float32 minus
int64 to float64) and clipped to [0, 1], the four-tap sum in float64, and
0 where the source leaves the frame.
"""

from __future__ import annotations

import torch


def undistort_map(camera: dict, distortion: dict, H: int, W: int):
    """(map_x, map_y) [H, W] float32 on the CPU: each destination pixel's
    source position in the raw frame of the same K."""
    f64 = torch.float64
    yy = torch.arange(H, dtype=f64)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=f64)[None, :].expand(H, W)
    fx, fy, cx, cy = camera["fx"], camera["fy"], camera["cx"], camera["cy"]
    k1, k2, p1, p2 = (distortion[k] for k in ("k1", "k2", "p1", "p2"))
    x = (xx - cx) / fx
    y = (yy - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return (fx * x_d + cx).to(torch.float32), (fy * y_d + cy).to(torch.float32)


def undistort(frames: torch.Tensor, camera: dict, distortion: dict) -> torch.Tensor:
    """Undistorted frames [..., H, W] float32 of raw frames [..., H, W]."""
    H, W = frames.shape[-2:]
    map_x, map_y = (m.to(frames.device) for m in undistort_map(camera, distortion, H, W))
    x0 = torch.clamp(torch.floor(map_x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(map_y).to(torch.int64), 0, H - 2)
    fx = torch.clamp(map_x.double() - x0.double(), 0.0, 1.0)
    fy = torch.clamp(map_y.double() - y0.double(), 0.0, 1.0)
    img = frames.double()
    out = (img[..., y0, x0] * (1 - fx) * (1 - fy) + img[..., y0, x0 + 1] * fx * (1 - fy)
           + img[..., y0 + 1, x0] * (1 - fx) * fy + img[..., y0 + 1, x0 + 1] * fx * fy)
    oob = (map_x < 0) | (map_x > W - 1) | (map_y < 0) | (map_y > H - 1)
    return torch.where(oob, 0.0, out).to(torch.float32)
