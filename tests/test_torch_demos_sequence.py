"""Port parity: the sequence demo (``epivo_tpu_torch/tools/sequence_demo.py``)
against the JAX package's (``examples/sequence_demo.py``, run in this
process on the CPU by ``tests.reference_accuracy.run_jax_example``), both
on the JAX demo's scene (``tools/demo_scenes.npz``, held to its draw by
``tests/test_torch_demos.py``): ``RESULT ok=True`` from both, the same
artifact files, and the port's VO and BA runner ATEs at most 1.5x the JAX
demo's (the repo's rule where the RANSAC draws differ)."""

import contextlib
import io
import os
import re

import torch

from epivo_tpu_torch.tools import sequence_demo
from tests.reference_accuracy import run_jax_example

torch.set_num_threads(1)


def _ates(text: str) -> dict:
    return {m[0]: float(m[1]) for m in re.findall(r"(VO|BA) runner: ATE=([0-9.]+) m", text)}


def test_sequence_demo(tmp_path):
    out, ref_out = str(tmp_path / "port"), str(tmp_path / "jax")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sequence_demo.main(["--device", "cpu", "--out", out])
    text = buf.getvalue()
    ref_rc, ref_text = run_jax_example("sequence_demo", ["--out", ref_out])
    print(f"port:\n{text}\nJAX demo:\n{ref_text}")
    assert rc == ref_rc == 0 and "RESULT ok=True" in text and "RESULT ok=True" in ref_text
    expect = {"kitti.T", "kitti.GT", "pts.cld", "lims", "traj.png"}
    assert expect <= set(os.listdir(out)) and set(os.listdir(out)) == set(os.listdir(ref_out))
    got, ref = _ates(text), _ates(ref_text)
    assert set(got) == set(ref) == {"VO", "BA"}
    for k in ("VO", "BA"):
        assert got[k] <= 1.5 * ref[k], (k, got, ref)
