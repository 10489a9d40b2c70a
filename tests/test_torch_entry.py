"""Port parity: ``epivo_tpu_torch.entry.entry()`` against the JAX
package's ``__graft_entry__.entry()``.

- its frames bit-equal to the reference's arguments;
- its ``VOConfig`` equal to the reference's field by field
  (``convert.config_from_reference``);
- ``entry("cpu")``: ``fn`` runs one ``vo_step`` on the CPU (finite pose
  and inlier count), and a repeat with the generator re-seeded is
  bit-equal; ``entry()`` without a card raises (nothing falls back to the
  CPU unless it is asked for).
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from epivo_tpu_torch import convert
from epivo_tpu_torch.entry import entry

torch.set_num_threads(1)


def _cfg(fn):
    """The configuration an entry's step closes over."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))["cfg"]


def test_entry_matches_reference():
    j_fn, (j0, j1, _) = __graft_entry__.entry()
    fn, (img0, img1, gen) = entry("cpu")
    assert img0.dtype == torch.float32 and img0.shape == (376, 1241)
    np.testing.assert_array_equal(img0.numpy(), np.asarray(j0))
    np.testing.assert_array_equal(img1.numpy(), np.asarray(j1))
    assert _cfg(fn) == convert.config_from_reference(_cfg(j_fn))
    assert gen.device.type == "cpu" and gen.initial_seed() == 0


def test_entry_runs_on_cpu():
    fn, args = entry("cpu")
    out = fn(*args)
    args[2].manual_seed(0)
    again = fn(*args)
    assert torch.isfinite(out.T).all() and out.T.shape == (4, 4)
    assert int(out.n_tracked) > 0
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_entry_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
