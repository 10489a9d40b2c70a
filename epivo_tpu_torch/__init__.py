"""epivo_tpu_torch: the PyTorch/CUDA port of ``epivo_tpu``.

Same module paths and public names as the JAX package (``epivo_tpu`` is
the reference and stays untouched): ``epivo_tpu_torch/frontend/fast.py``
mirrors ``epivo_tpu/frontend/fast.py`` and so on. Plain tensor code is
PyTorch; each Pallas kernel of the reference is a hand-written CUDA C++
kernel under ``csrc/`` (built on first use by :mod:`._kernels`), with a
plain PyTorch version beside it that serves as the CPU path and as its
oracle.

Importing the package sets PyTorch's float32 policy (see
:func:`._device.set_f32_precision`):

- ``torch.backends.cuda.matmul.allow_tf32 = False``: matmuls run in full
  float32, the counterpart of the reference pinning
  ``jax_default_matmul_precision`` to "highest";
- ``torch.backends.cudnn.allow_tf32 = False``: cuDNN's default is TF32,
  which keeps about three decimal digits.

The package imports neither ``jax`` nor ``epivo_tpu``.
"""

__version__ = "0.1.0"

from epivo_tpu_torch._device import set_f32_precision as _set_f32_precision

_set_f32_precision()
