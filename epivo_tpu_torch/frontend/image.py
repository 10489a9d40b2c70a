"""Image utilities: bilinear sampling, patches, gradients and pyramids
(port of ``epivo_tpu/frontend/image.py``).

Filters are explicit shifted-slice sums in the reference's order of terms,
not ``conv2d``: cuDNN would run a float32 convolution in TF32 by default
and sum in its own order, and the pyramid would no longer match the
reference bit for bit. Images are [..., H, W].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from epivo_tpu_torch._device import constant

# 5-tap binomial and Scharr taps; every value is exact in float32.
_BINOMIAL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_SCHARR_S = (3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0)
_SCHARR_D = (-0.5, 0.0, 0.5)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample image [H, W] at subpixel positions xy [..., 2] (x, y order).

    Out-of-bounds coordinates clamp to the border (OpenCV's
    BORDER_REPLICATE, which calcOpticalFlowPyrLK's gather uses).
    """
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = x - x0.to(img.dtype)
    fy = y - y0.to(img.dtype)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def patch_coords(center: torch.Tensor, size: int) -> torch.Tensor:
    """[..., 2] centers -> [..., size, size, 2] sample coordinates (x, y)."""
    r = (size - 1) / 2.0
    offs = torch.arange(size, dtype=center.dtype, device=center.device) - r
    ox, oy = torch.meshgrid(offs, offs, indexing="xy")  # ox varies along x
    grid = torch.stack([ox, oy], dim=-1)  # [size, size, 2]
    return center[..., None, None, :] + grid


def extract_patch(img: torch.Tensor, center: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear patch extraction: [H, W] x [..., 2] -> [..., size, size]."""
    return bilinear_sample(img, patch_coords(center, size))


def central_gradients(img: torch.Tensor):
    """Central-difference gradients (Ix, Iy) of [..., H, W], zero on the
    one-pixel border of each axis."""
    Ix = torch.zeros_like(img)
    Iy = torch.zeros_like(img)
    Ix[..., :, 1:-1] = (img[..., :, 2:] - img[..., :, :-2]) * 0.5
    Iy[..., 1:-1, :] = (img[..., 2:, :] - img[..., :-2, :]) * 0.5
    return Ix, Iy


def edge_pad(img: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Pad the last two axes by replicating the edge (``mode="edge"``)."""
    H, W = img.shape[-2:]
    rows = torch.clamp(torch.arange(-top, H + bottom, device=img.device), 0, H - 1)
    cols = torch.clamp(torch.arange(-left, W + right, device=img.device), 0, W - 1)
    return img[..., rows, :][..., :, cols]


def _sep_conv3(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 3-tap convolution with edge padding: kx along x, ky along y."""
    H, W = img.shape[-2:]
    p = edge_pad(img, 1, 1, 1, 1)
    h = sum(p[..., :, i : i + W] * kx[i] for i in range(3))  # [..., H+2, W]
    return sum(h[..., i : i + H, :] * ky[i] for i in range(3))  # [..., H, W]


def scharr_gradients(img: torch.Tensor):
    """(Ix, Iy) via the 3x3 Scharr operator, normalized so a unit ramp has
    unit gradient."""
    return _sep_conv3(img, _SCHARR_D, _SCHARR_S), _sep_conv3(img, _SCHARR_S, _SCHARR_D)


def downsample2(img: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x downsample: 5-tap binomial blur evaluated only at the
    kept (even) pixels, via phase-split reshapes, with the reference's
    terms in the reference's order."""
    k = _BINOMIAL
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    Ho, Wo = (H + 1) // 2, (W + 1) // 2

    # Vertical blur at even output rows: out_v[i] = sum_j k[j] * p[2i + j].
    p = edge_pad(img, 2, 2 * Ho + 2 - H, 0, 0)  # [..., 2Ho+4, W]
    ph = p.reshape(lead + (Ho + 2, 2, W))
    ph0, ph1 = ph[..., :, 0, :], ph[..., :, 1, :]
    out_v = (
        k[0] * ph0[..., :Ho, :] + k[1] * ph1[..., :Ho, :]
        + k[2] * ph0[..., 1 : Ho + 1, :] + k[3] * ph1[..., 1 : Ho + 1, :]
        + k[4] * ph0[..., 2 : Ho + 2, :]
    )  # [..., Ho, W]

    # Horizontal blur at even output columns (same phase trick).
    q = edge_pad(out_v, 0, 0, 2, 2 * Wo + 2 - W)  # [..., Ho, 2Wo+4]
    qh = q.reshape(lead + (Ho, Wo + 2, 2))
    qh0, qh1 = qh[..., 0], qh[..., 1]
    return (
        k[0] * qh0[..., :Wo] + k[1] * qh1[..., :Wo]
        + k[2] * qh0[..., 1 : Wo + 1] + k[3] * qh1[..., 1 : Wo + 1]
        + k[4] * qh0[..., 2 : Wo + 2]
    )  # [..., Ho, Wo]


def build_pyramid(img: torch.Tensor, levels: int):
    """List of images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


@functools.lru_cache(maxsize=64)
def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of ``jax.image.resize(...,
    method="linear")`` along one axis: the triangle kernel of its
    scale-and-translate, widened by the shrink factor (antialiasing),
    normalised per output sample, computed in float32 in the reference's
    order of operations."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_taps(n_in: int, n_out: int):
    """The nonzero part of :func:`_triangle_weights` as taps: input indices
    and weights [T, n_out], T the widest support (zero-weight padding)."""
    w = _triangle_weights(n_in, n_out)
    nz = w != 0
    first = np.argmax(nz, axis=0)
    T = max(int(nz.sum(0).max()), 1)
    idx = first[None, :] + np.arange(T)[:, None]
    inside = idx < n_in
    idx = np.minimum(idx, n_in - 1)
    wt = np.where(inside, w[idx, np.arange(n_out)[None, :]], np.float32(0.0))
    return idx.astype(np.int64), wt.astype(np.float32)


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(img, (out_h, out_w), method="linear")`` for
    [..., H, W] images: the reference's per-axis triangle weights, applied
    as explicit tap sums (rows, then columns; each sum in ascending input
    order). Elementwise, so a frame's result does not depend on the batch
    it sits in or on the device; only the order of each sum's few nonzero
    terms can differ from the reference's contraction."""
    H, W = img.shape[-2:]
    iy, wy = _resize_taps(H, out_h)
    ix, wx = _resize_taps(W, out_w)
    dev = img.device
    iy_t, ix_t = constant(iy, torch.int64, dev), constant(ix, torch.int64, dev)
    wy_t, wx_t = constant(wy, img.dtype, dev), constant(wx, img.dtype, dev)
    rows = sum(img.index_select(-2, iy_t[k]) * wy_t[k][:, None] for k in range(len(iy)))
    return sum(rows.index_select(-1, ix_t[k]) * wx_t[k] for k in range(len(ix)))
