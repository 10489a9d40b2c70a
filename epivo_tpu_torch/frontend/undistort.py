"""Radial-tangential undistortion of raw frames inside the step.

For each destination (pinhole) pixel, the bilinear sample of the raw
frame at that pixel's distorted position, 0 where the position leaves the
frame: ``remap(img, *undistort_map(K, dist, (H, W)))`` of
``datasets/euroc.py``, bit for bit, with the destination camera equal to
the source camera.

On a CUDA tensor, :func:`undistort` runs ``csrc/undistort.cu`` (the map
computed per pixel in the kernel, one launch for every frame of a call);
on a CPU tensor the plain :func:`undistort_plain`, which is the kernel's
oracle: the map from numpy's float64 arithmetic in numpy's order, rounded
to float32, and the four-tap blend in float64 with explicit casts where
numpy promotes (float32 minus int64 is float64 in numpy, float32 in
torch).
"""

from __future__ import annotations

import functools

import torch

from epivo_tpu_torch import _kernels
from epivo_tpu_torch._device import kernel_wanted
from epivo_tpu_torch.geometry.camera import Distortion, Pinhole

# Launches of the CUDA kernel made by this process (never by the plain path).
LAUNCHES = 0


@functools.lru_cache(maxsize=8)
def undistort_map(camera: Pinhole, dist: Distortion, H: int, W: int):
    """(map_x, map_y) [H, W] float32 on the CPU: each destination pixel's
    source position in the raw frame, in ``datasets/euroc.py::
    undistort_map``'s float64 arithmetic and order. Computed on the CPU,
    where torch divides by a scalar exactly (on CUDA it multiplies by the
    reciprocal)."""
    f64 = torch.float64
    yy = torch.arange(H, dtype=f64)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=f64)[None, :].expand(H, W)
    k1, k2, p1, p2 = dist.k1, dist.k2, dist.p1, dist.p2
    x = (xx - camera.cx) / camera.fx
    y = (yy - camera.cy) / camera.fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    map_x = camera.fx * x_d + camera.cx
    map_y = camera.fy * y_d + camera.cy
    return map_x.to(torch.float32), map_y.to(torch.float32)


def remap(frames: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of frames [..., H, W] float32 by maps [H, W] float32
    (``datasets/euroc.py::remap`` on each frame, bit for bit)."""
    H, W = frames.shape[-2:]
    map_x, map_y = map_x.to(frames.device), map_y.to(frames.device)
    x0 = torch.clamp(torch.floor(map_x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(map_y).to(torch.int64), 0, H - 2)
    fx = torch.clamp(map_x.double() - x0.double(), 0.0, 1.0)
    fy = torch.clamp(map_y.double() - y0.double(), 0.0, 1.0)
    img = frames.double()
    v00 = img[..., y0, x0]
    v01 = img[..., y0, x0 + 1]
    v10 = img[..., y0 + 1, x0]
    v11 = img[..., y0 + 1, x0 + 1]
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    oob = (map_x < 0) | (map_x > W - 1) | (map_y < 0) | (map_y > H - 1)
    return torch.where(oob, 0.0, out).to(torch.float32)


def undistort_plain(frames: torch.Tensor, camera: Pinhole, dist: Distortion) -> torch.Tensor:
    """Undistorted frames [..., H, W] float32 of raw frames [..., H, W]
    (plain version, the kernel's oracle)."""
    H, W = frames.shape[-2:]
    return remap(frames, *undistort_map(camera, dist, H, W))


def _frames(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name} needs contiguous float32 [n, H, W] frames, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x


def undistort_kernel(frames0: torch.Tensor, frames1: torch.Tensor | None, camera: Pinhole,
                     dist: Distortion) -> torch.Tensor:
    """Undistorted frames [n0 + n1, H, W] of CUDA frames0 [n0, H, W] and
    frames1 [n1, H, W] (or None) by one launch of the CUDA kernel, on the
    current stream, with no host sync. Bit-identical to
    :func:`undistort_plain` of the frames stacked."""
    global LAUNCHES
    a = _frames(frames0, "undistort_kernel")
    b = a[:0] if frames1 is None else _frames(frames1, "undistort_kernel")
    if b.shape[1:] != a.shape[1:] or b.device != a.device:
        raise ValueError(f"frames of {tuple(a.shape[1:])} on {a.device} and "
                         f"{tuple(b.shape[1:])} on {b.device}")
    n0, H, W = a.shape
    out = torch.empty((n0 + b.shape[0], H, W), dtype=torch.float32, device=a.device)
    if out.numel():
        status = _kernels.lib().epivo_undistort(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n0, b.shape[0], H, W,
            float(camera.fx), float(camera.fy), float(camera.cx), float(camera.cy),
            float(dist.k1), float(dist.k2), float(dist.p1), float(dist.p2),
            _kernels.stream_of(a))
        _kernels.check(status, "epivo_undistort")
        LAUNCHES += 1
    return out


def undistort(frames, camera: Pinhole, dist: Distortion,
              use_kernel: bool | None = None) -> torch.Tensor:
    """Undistorted frames of raw ``frames`` through ``camera``'s lens
    ``dist``: a float32 tensor [n, H, W], or a pair of them (a step's
    source and target frames), undistorted into one [n0 + n1, H, W].

    ``use_kernel=None`` runs the CUDA kernel (one launch) for CUDA frames
    and the plain version for CPU frames; both give the same bits.
    """
    first = frames[0] if isinstance(frames, (tuple, list)) else frames
    if kernel_wanted(first, use_kernel):
        if isinstance(frames, (tuple, list)):
            return undistort_kernel(*frames, camera, dist)
        return undistort_kernel(frames, None, camera, dist)
    if isinstance(frames, (tuple, list)):
        frames = torch.cat(list(frames))
    return undistort_plain(frames, camera, dist)
