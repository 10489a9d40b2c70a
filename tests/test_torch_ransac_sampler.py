"""Both packages' RANSAC samplers drawn on one masked match set
(``epivo_tpu/ransac.py::_sample_indices``, Gumbel-top-k from
``jax.random.gumbel``; ``epivo_tpu_torch/ransac.py::_sample_indices``,
Gumbel-top-k from ``-log(-log(u))`` on ``torch.rand``): N = 96 matches of
which 50 are valid, 40,000 hypotheses of 8 indices.

Each sample must hold valid indices only and no index twice, and each
valid index's inclusion frequency must lie within 5 binomial standard
deviations of k / N_valid = 0.16 (std sqrt(p (1 - p) / n_hyp) = 0.0018),
in both packages: the samplers draw from the same distribution, so it is
not why the port's no-GT trajectories from its own draws read worse
(``ROADMAP.md`` C1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu import ransac as jransac
from epivo_tpu_torch import ransac as transac

torch.set_num_threads(1)

N, N_VALID, K, N_HYP = 96, 50, 8, 40_000


def _mask() -> np.ndarray:
    mask = np.zeros(N, bool)
    mask[np.random.default_rng(0).choice(N, N_VALID, replace=False)] = True
    return mask


def _draw(package: str, mask: np.ndarray) -> np.ndarray:
    if package == "jax":
        idx = jransac._sample_indices(jax.random.PRNGKey(0), N_HYP, N, jnp.asarray(mask), K)
        return np.asarray(idx)
    g = torch.Generator().manual_seed(0)
    return transac._sample_indices(g, N_HYP, N, torch.from_numpy(mask), K).numpy()


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_sampler_distribution(package):
    mask = _mask()
    idx = _draw(package, mask)
    assert idx.shape == (N_HYP, K)
    assert mask[idx].all(), "an invalid index was drawn"
    s = np.sort(idx, axis=-1)
    assert (np.diff(s, axis=-1) > 0).all(), "an index was drawn twice in one sample"
    freq = np.bincount(idx.ravel(), minlength=N)[mask] / N_HYP
    p = K / N_VALID
    std = np.sqrt(p * (1 - p) / N_HYP)
    dev = np.abs(freq - p).max()
    print(f"{package}: inclusion frequency mean {freq.mean():.4f}, std {freq.std():.4f}, "
          f"range {freq.min():.4f}-{freq.max():.4f}; expected {p:.4f}, binomial std {std:.4f}")
    assert dev <= 5 * std, (dev, 5 * std)
