"""Image utilities: Scharr gradients, edge padding and pyramids
(a frozen copy of the port's ``epivo_tpu_torch/frontend/image.py``).

Filters are explicit shifted-slice sums in the reference's order of terms,
not ``conv2d``: cuDNN would run a float32 convolution in TF32 by default
and sum in its own order, and the pyramid would no longer match the
reference bit for bit. Images are [..., H, W].
"""

from __future__ import annotations

import torch


# 5-tap binomial and Scharr taps; every value is exact in float32.
_BINOMIAL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
_SCHARR_S = (3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0)
_SCHARR_D = (-0.5, 0.0, 0.5)


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


