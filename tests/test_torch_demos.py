"""Port parity: the synthetic demo (``epivo_tpu_torch/tools/synthetic_vo_demo.py``)
against the JAX package's (``examples/synthetic_vo_demo.py``, run in this
process on the CPU by ``tests.reference_accuracy.run_jax_example``).

- ``tools/demo_scenes.npz`` holds each JAX demo's scene bit-equal to its
  ``jax.random.PRNGKey(0)`` draw (the port cannot reproduce
  ``jax.random``; ``python -m tests.test_torch_demos`` rewrites the file);
- the KLT demo, both on that scene: ``RESULT ok=True`` from both, and the
  port's E-pose and LM-pose errors within 1e-3 of the JAX demo's (the LM
  refinement and the pose recovered from RANSAC's E reach the same pose
  whatever the hypotheses drawn);
- ``--flat``: both print ``DEGENERATE: too few tracks`` and the same
  fallback translation;
- ``--orb``: ``RESULT ok=True`` from both, and the port's errors at most
  1.5x the JAX demo's (the repo's rule where the RANSAC draws differ).

The sequence demo is in ``tests/test_torch_demos_sequence.py``.
"""

import contextlib
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epivo_tpu_torch.tools import synthetic_vo_demo
from tests.reference_accuracy import demo_errors, run_jax_example

torch.set_num_threads(1)


def _reference_scenes() -> dict:
    """Each JAX demo's scene, drawn as the demo draws it."""
    k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    z = jax.random.uniform(k1, (160,), minval=8.0, maxval=20.0)
    xy = jax.random.uniform(k2, (160, 2), minval=-0.45, maxval=0.45) * z[:, None]
    vo = np.asarray(jnp.concatenate([xy, z[:, None]], axis=-1))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    z = jax.random.uniform(k1, (140,), minval=6.0, maxval=18.0)
    xy = jax.random.uniform(k2, (140, 2), minval=-0.7, maxval=0.7) * z[:, None]
    seq = np.asarray(jnp.concatenate([xy, z[:, None]], axis=-1))
    return {"vo_demo": vo, "sequence_demo": seq}


def _run(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _both(flags: list) -> tuple:
    """(port's exit status, its output, JAX demo's status, its output)."""
    rc, text = _run(synthetic_vo_demo.main, ["--device", "cpu", *flags])
    ref_rc, ref_text = run_jax_example("synthetic_vo_demo", flags)
    print(f"port:\n{text}\nJAX demo:\n{ref_text}")
    return rc, text, ref_rc, ref_text


def test_demo_scenes_are_the_reference_draws():
    ref = _reference_scenes()
    for name, pts in ref.items():
        stored = synthetic_vo_demo.demo_scene(name)
        assert stored.dtype == np.float32 and np.array_equal(stored, pts), name


def test_synthetic_demo_matches_reference():
    rc, text, ref_rc, ref_text = _both([])
    assert rc == ref_rc == 0 and "RESULT ok=True" in text and "RESULT ok=True" in ref_text
    got, ref = demo_errors(text), demo_errors(ref_text)
    for name in ("E-pose", "LM-pose"):
        assert np.allclose(got[name], ref[name], rtol=0, atol=1e-3), (name, got, ref)


@pytest.mark.parametrize("flag", ["--flat", "--orb"])
def test_synthetic_demo_probes(flag):
    rc, text, ref_rc, ref_text = _both([flag])
    assert rc == ref_rc == 0
    if flag == "--flat":
        for out in (text, ref_text):
            assert "DEGENERATE: too few tracks" in out and "RESULT ok=degenerate-handled" in out
        fallback = [re.search(r"fallback R=I, t=.*", out).group(0) for out in (text, ref_text)]
        assert fallback[0] == fallback[1], fallback
    else:
        assert "RESULT ok=True" in text and "RESULT ok=True" in ref_text
        got, ref = demo_errors(text)["ORB-pose"], demo_errors(ref_text)["ORB-pose"]
        assert got[0] <= 1.5 * ref[0] and got[1] <= 1.5 * ref[1], (got, ref)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez(synthetic_vo_demo.SCENES, **_reference_scenes())
    print(f"wrote {synthetic_vo_demo.SCENES}", file=sys.stderr)
