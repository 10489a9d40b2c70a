"""Device and precision policy shared by the port's modules."""

from __future__ import annotations

import numpy as np
import torch


def set_f32_precision() -> None:
    """Keep float32 math in float32 on the GPU.

    Epipolar geometry in f32 needs true f32 products: TF32 keeps about
    three decimal digits, enough to move two-view pose estimates
    visibly. Both switches are set because cuDNN allows TF32 by default
    (the matmul switch alone leaves convolutions in TF32).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def constant(data, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant (nested lists or a numpy array) on ``device``.

    ``torch.tensor(data, device="cuda")`` copies with a stream sync; this
    builds the tensor on the host and copies it with ``non_blocking=True``,
    so the batched entry points stay free of host syncs.
    """
    return torch.as_tensor(data, dtype=dtype).to(device, non_blocking=True)


def upload(frames: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``: staged through pinned memory and copied
    without blocking, so the host goes on issuing work."""
    t = torch.from_numpy(np.ascontiguousarray(frames))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def kernel_wanted(x: torch.Tensor, use_kernel: bool | None) -> bool:
    """Resolve a wrapper's ``use_kernel`` switch against its input.

    ``None`` picks the hand-written kernel for a CUDA tensor and the plain
    PyTorch version for a CPU tensor (the counterpart of the reference's
    ``fast._use_pallas_default``). ``True`` on a CPU tensor raises: the
    kernels exist only for the GPU and nothing falls back.
    """
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError(
            f"use_kernel=True needs a CUDA tensor, got one on {x.device}"
        )
    return bool(use_kernel)


def runner_device(device=None) -> torch.device:
    """The device a sequence runner works on: ``device`` when given, else
    the CUDA card. Raises when CUDA is asked for and there is none:
    nothing continues on the CPU unless the CPU is asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass device='cpu' to run on the CPU")
    return dev
